"""Host-RAM cold tier: segment-wave search over a database kept in host
memory.

Port of ``src/repro/search/hosttier.py``.  ``Index.build(...,
residency="host")`` keeps the packed database in host memory (pinned on a
CUDA build, so that copies to the card can run asynchronously) and bounds
the device memory a search uses to a planner-sized budget
(``repro_torch.search.plan.plan_segments``): each search streams the rows
through the device in fixed-size segment waves.

:func:`wave_program` is one wave, an assembly of the shared stages and
backends: the segment's search by the index's backend — on the card the
``"cuda"`` backend's kernels (the fused scan and its merge, two launches;
on the CPU their plain versions), on ``"torch"`` the plain score tile —
with the bins planned over the segment's rows and recall accounted
against the global capacity (``reduction_input_size_override``, the
Eq. 13–14 composition argument of a §7 shard), the quantized tiers
rescored from the segment's own f32 tail with local ids, then the ids
offset by the segment's first row and ``stages.merge_topk`` into the
(m, k) carry, which keeps the lowest global index among equal values.
The metric's sign flip is applied once, after the last wave.

:class:`HostTierSearcher` drives the waves through two device slots
allocated once: on the card the copy of wave i+1 runs on a side stream
(``non_blocking`` from pinned memory) while the compute stream scans wave
i; a scan waits for its slot's copy, and a copy waits for the scan that
last read its slot.  On the CPU the same code copies into the slots
plainly.  ``DISPATCH_COUNTS["host"]`` rises once per wave.  Searches of
one searcher from several threads issue their waves one search at a time.

On the ``"cuda"`` backend a slot is the segment (rounded up to the
kernels' ``BLOCK_N``) and a wave's bins must tile it, so the wave's bin is
at most the largest power of two dividing the slot (:func:`wave_bins`);
a budget-planned segment therefore keeps its two slots inside the budget.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import torch

from repro_torch.core.binning import (
    BinPlan, expected_recall, plan_bins, round_up,
)
from repro_torch.kernels import partial_reduce as kernels
from repro_torch.search import backends, telemetry
from repro_torch.search.metrics import get_metric
from repro_torch.search.stages import MASK_VALUE, finalize_values, merge_topk

__all__ = ["HostTierSearcher", "wave_bins", "wave_program"]

# the per-row operands of a packed state a wave streams, in wave order
_OPERANDS = ("db", "bias", "scale", "rescore_db", "rescore_bias")
# the ones that are (1, n_pad) rows in the "cuda" layout, (n,) otherwise
_ROW_VECTORS = ("bias", "scale")


def _rows(name: str, t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of the packed operand ``name`` of either layout."""
    return t[:, lo:hi] if name in _ROW_VECTORS and t.ndim == 2 else t[lo:hi]


def _signature(pk) -> tuple:
    """What a searcher's slots depend on: the capacity and each operand's
    dtype and row width."""
    return (pk.n,) + tuple(
        None if t is None else (t.dtype, t.ndim, t.shape[-1] if name not in
                                _ROW_VECTORS else None)
        for name, t in ((name, getattr(pk, name)) for name in _OPERANDS))


def wave_bins(segment_rows: int, k: int, recall_target: float,
              capacity: int, backend: str) -> BinPlan:
    """A wave's bins: planned over the segment's rows with recall
    accounted against the ``capacity`` (the reference's); on ``"cuda"``
    the bin is capped at the largest power of two dividing the kernels'
    slot, ``round_up(segment_rows, BLOCK_N)``, so that whole bins tile it
    (more, smaller bins where the cap binds: E[recall] only rises)."""
    bp = plan_bins(segment_rows, k, recall_target,
                   reduction_input_size_override=capacity)
    if backend != "cuda":
        return bp
    slot = round_up(segment_rows, kernels.BLOCK_N)
    w = min(bp.log2_bin_size, (slot & -slot).bit_length() - 1)
    if w == bp.log2_bin_size:
        return bp
    bins = -(-segment_rows // (1 << w))
    return BinPlan(n=segment_rows, k=k, num_bins=bins, log2_bin_size=w,
                   padded_n=bins << w,
                   expected_recall=expected_recall(
                       bins * max(1, capacity // segment_rows), k))


def wave_program(
    queries: torch.Tensor,
    seg_db: torch.Tensor,
    seg_bias: torch.Tensor,
    seg_scale: Optional[torch.Tensor],
    seg_rescore_db: Optional[torch.Tensor],
    seg_rescore_bias: Optional[torch.Tensor],
    offset: int,
    carry_vals: torch.Tensor,
    carry_idxs: torch.Tensor,
    *,
    backend: str,
    metric: str,
    k: int,
    k_scan: int,
    recall_target: float,
    global_n: int,
    segment_rows: int,
    bin_size: int,
    is_last: bool,
    use_bitonic: bool = False,
    fused_select: bool = True,
    int4_packed: bool = False,
    query_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One segment wave: search the segment, offset its ids, merge them
    into the carry (the reference's ``wave_program``).

    The segment operands are in ``backend``'s packed layout:
    ``segment_rows`` real rows (a ``"cuda"`` slot holds them rounded up to
    ``BLOCK_N``, masked), ``bin_size`` the wave's bins (:func:`wave_bins`),
    ``k_scan`` the scan's k for a rescore tail.
    ``carry_vals``/``carry_idxs`` (m, k) are in the internal max
    convention; ``is_last`` applies the metric's sign flip to the result.
    ``query_block`` bounds the plain path's (rows, segment_rows) score
    tile; the kernels take any M in one call.
    """
    m_obj = get_metric(metric)
    operands = (queries, seg_db, seg_bias, seg_scale, seg_rescore_db,
                seg_rescore_bias)
    common = dict(metric=metric, k=k, k_scan=k_scan, use_bitonic=use_bitonic)
    if backend == "cuda":
        vals, idxs = backends.cuda_search_packed_quant(
            *operands, n=segment_rows, bin_size=bin_size,
            fused_select=fused_select, int4_packed=int4_packed, **common)
        # masked winners keep the sentinel index -1
        idxs = torch.where(idxs >= 0, idxs + offset, idxs)
    else:
        qb = query_block or max(1, queries.shape[0])
        parts = [backends.dense_search_quant(
            queries[s : s + qb], *operands[1:], recall_target=recall_target,
            reduction_input_size_override=global_n, **common)
            for s in range(0, max(1, queries.shape[0]), qb)]
        vals = torch.cat([v for v, _ in parts])
        idxs = torch.cat([i for _, i in parts]) + offset
    # the backends return public values; the carry merges internal ones
    vals = finalize_values(vals, m_obj.negate_output)
    vals, idxs = merge_topk(carry_vals, carry_idxs, k, extra_vals=vals,
                            extra_idxs=idxs, use_bitonic=use_bitonic)
    if is_last:
        vals = finalize_values(vals, m_obj.negate_output)
    return vals, idxs


class HostTierSearcher:
    """Callable ``(queries, packed_state) -> (values, indices)``
    that drives the segment waves over a host-resident ``PackedState``.

    Built once per index and layout (``Index`` caches it): the two device
    slots are allocated here and reused by every search, so a search
    allocates nothing the size of a segment.  A lock holds one search's
    waves together, so that searches from several threads (a server's
    worker and a direct caller) never stage into each other's slots.
    ``record_timing=True`` keeps each wave's CUDA events of the last
    search in ``wave_events`` as ``(copy_start, copy_end, scan_start,
    scan_end)``.
    """

    def __init__(self, spec, pk, *, backend: str, device, segment_rows: int,
                 k_scan: int, query_block: Optional[int] = None):
        if segment_rows <= 0:
            raise ValueError(
                f"segment_rows must be positive, got {segment_rows}")
        self.spec = spec
        self.backend = backend
        self.device = torch.device(device)
        self.segment_rows = segment_rows
        self.query_block = query_block
        self.num_segments(pk.n)  # whole waves only
        self._signature = _signature(pk)
        self.int4_packed = pk.int4_packed
        self.rescore = pk.rescore_db is not None
        self.k_scan = k_scan
        # the wave's scan k and bins (the reference's: k_scan capped by the
        # segment, the bins over its rows against the global row space)
        self.wave_k_scan = min(k_scan, segment_rows)
        self.wave_plan = wave_bins(
            segment_rows, self.wave_k_scan if self.rescore else spec.k,
            spec.recall_target, pk.n, backend)
        self.bin_size = self.wave_plan.bin_size
        # a kernel slot holds whole BLOCK_N blocks (and so whole bins): the
        # rows past the segment stay masked (zero rows, bias MASK, scale 0)
        self.slot_rows = (round_up(segment_rows, kernels.BLOCK_N)
                          if backend == "cuda" else segment_rows)
        self._lock = threading.Lock()
        self._cuda = self.device.type == "cuda"
        self.slots = [self._alloc_slot(pk) for _ in range(2)]
        # the bytes each wave copies to the device
        self.wave_bytes = sum(
            _rows(name, t, 0, segment_rows).numel() * t.element_size()
            for name, t in self.slots[0].items() if t is not None)
        self.record_timing = False
        self.wave_events: List[tuple] = []
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(self.device)
            self._copied = [torch.cuda.Event() for _ in range(2)]
            self._freed = [torch.cuda.Event() for _ in range(2)]
            self._last_copy = torch.cuda.Event()
            for slot in self.slots:
                for t in slot.values():
                    if t is not None:
                        t.record_stream(self._copy_stream)

    def num_segments(self, capacity: int) -> int:
        if capacity % self.segment_rows:
            raise ValueError(
                f"capacity {capacity} is not a whole number of "
                f"{self.segment_rows}-row segments — Index.build/add must "
                "pad capacity to whole waves"
            )
        return capacity // self.segment_rows

    def matches(self, pk, k_scan: int) -> bool:
        """Whether this searcher's slots and statics fit ``pk`` and
        ``k_scan`` (else the index builds a new one: growth, a re-bound
        ``k_scan``)."""
        return _signature(pk) == self._signature and k_scan == self.k_scan

    def _alloc_slot(self, pk) -> dict:
        """One device tensor per operand, in the backend's layout: the
        scanned operands hold ``slot_rows`` (the rows past the segment
        masked), the rescore tail ``segment_rows`` (local-id gathers)."""
        slot = {}
        for name in _OPERANDS:
            t = getattr(pk, name)
            if t is None:
                slot[name] = None
                continue
            rows = (self.segment_rows if name.startswith("rescore")
                    else self.slot_rows)
            if name in _ROW_VECTORS and t.ndim == 2:
                shape = (1, rows)
            else:
                shape = (rows,) + tuple(t.shape[1:])
            fill = MASK_VALUE if name == "bias" else 0
            slot[name] = torch.full(shape, fill, dtype=t.dtype,
                                    device=self.device)
        return slot

    def _stage(self, pk, wave: int) -> None:
        """Copy one segment's operands into the wave's slot."""
        lo, hi = wave * self.segment_rows, (wave + 1) * self.segment_rows
        slot = self.slots[wave % 2]
        for name in _OPERANDS:
            if slot[name] is not None:
                _rows(name, slot[name], 0, self.segment_rows).copy_(
                    _rows(name, getattr(pk, name), lo, hi),
                    non_blocking=self._cuda)

    def _stage_async(self, pk, wave: int, timing: Optional[list]) -> None:
        s = wave % 2
        with torch.cuda.stream(self._copy_stream):
            # the scan that last read this slot must be done with it
            self._copy_stream.wait_event(self._freed[s])
            start = self._event(timing)
            self._stage(pk, wave)
            end = self._event(timing)
            self._copied[s].record(self._copy_stream)
        if timing is not None:
            timing.append([start, end])

    @staticmethod
    def _event(timing: Optional[list]):
        if timing is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait_copies(self) -> None:
        """Block until every copy of the last search has read the host
        operands (before they are patched in place)."""
        if self._cuda:
            self._last_copy.synchronize()

    def __call__(self, queries: torch.Tensor, pk
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        # the events order the streams; the lock orders the issuing
        with self._lock:
            return self._search(queries, pk)

    def _search(self, queries: torch.Tensor, pk
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        spec = self.spec
        cap = pk.n
        waves = self.num_segments(cap)
        if self._cuda and not pk.db.is_pinned():
            raise RuntimeError(
                "a host-tier search on the card streams pinned host memory; "
                "the packed state is not pinned (Index places it)")
        seg = self.segment_rows
        m = queries.shape[0]
        carry_vals = torch.full((m, spec.k), MASK_VALUE, dtype=torch.float32,
                                device=self.device)
        # the kernels pair a masked entry with -1, the plain path with a row
        carry_idxs = torch.full((m, spec.k), -1 if self.backend == "cuda"
                                else 0, dtype=torch.int32, device=self.device)
        reg = telemetry.registry()
        reg.set_gauge("repro_hosttier_segments", waves, segment_rows=seg)
        statics = dict(
            backend=self.backend, metric=spec.metric, k=spec.k,
            k_scan=self.wave_k_scan, recall_target=spec.recall_target,
            global_n=cap, segment_rows=seg, bin_size=self.bin_size,
            use_bitonic=spec.use_bitonic,
            fused_select=spec.fused_select_enabled,
            int4_packed=self.int4_packed, query_block=self.query_block,
        )
        timing = [] if (self._cuda and self.record_timing) else None
        compute = torch.cuda.current_stream(self.device) if self._cuda else None
        if self._cuda:
            self._stage_async(pk, 0, timing)
        for i in range(waves):
            if self._cuda:
                if i + 1 < waves:
                    # the next wave's copy runs while this wave is scanned
                    self._stage_async(pk, i + 1, timing)
                compute.wait_event(self._copied[i % 2])
            else:
                self._stage(pk, i)
            backends.DISPATCH_COUNTS.inc("host")
            reg.inc("repro_hosttier_waves_total", segment_rows=seg)
            slot = self.slots[i % 2]
            scan_start = self._event(timing)
            carry_vals, carry_idxs = wave_program(
                queries, *(slot[name] for name in _OPERANDS), i * seg,
                carry_vals, carry_idxs, is_last=(i == waves - 1), **statics)
            if self._cuda:
                self._freed[i % 2].record(compute)
                if timing is not None:
                    timing[i] += [scan_start, self._event(timing)]
        if self._cuda:
            self._last_copy.record(self._copy_stream)
            if timing is not None:
                self.wave_events = [tuple(t) for t in timing]
        return carry_vals, carry_idxs

    def occupancy(self, pk) -> list:
        """Each segment's share of live rows (bias above MASK / 2): how much
        of each wave's streamed bytes scores real rows."""
        bias = pk.bias_row().float().cpu()
        return [float((bias[s * self.segment_rows : (s + 1) * self.segment_rows]
                       > MASK_VALUE * 0.5).float().mean())
                for s in range(self.num_segments(pk.n))]
