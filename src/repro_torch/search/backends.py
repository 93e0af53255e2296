"""Backends behind the search API.

Port of the single-device paths of ``src/repro/search/backends.py``.
All consume metric-prepared operands and an additive per-row bias, work
in the internal max convention and negate once for distance metrics:

  * :func:`dense_search` — the ``"torch"`` backend: the full score tile,
    then ``approx_max_k`` (the reference's ``"xla"`` path).
  * :func:`cuda_search_packed` — the ``"cuda"`` backend over packed
    operands (the reference's ``pallas_search_packed``): the fused
    scan→select kernel, or with ``fused_select=False`` the two-pass
    kernel, ``sentinelize_masked`` and ``merge_topk``.
  * :func:`dense_search_quant` and :func:`cuda_search_packed_quant` — the
    same two over any storage tier (``dense_search_quant`` and
    ``pallas_search_packed_quant``), and the one implementation of each
    (the f32 entry points above call them without a scale or a rescore
    tail): the scan over the stored rows keeps ``k_scan`` over-fetched
    candidates and ``rescore_candidates`` re-scores them exactly against
    the rescore tail; without a tail the scan's own scores are returned.
  * :func:`cluster_search` and :func:`cluster_search_quant` — the
    cluster-pruned scan over either layout (the reference's functions of
    the same names): the probed clusters' rows gathered and scored, the
    bins planned for the scanned slots.  The reference runs this path
    outside any Pallas kernel (an XLA gather and ``einsum``), and so does
    the port (a gather and a dot in a fixed order, ``stages.dot_rows``),
    in query chunks whose gathered rows fit ``GATHER_BUDGET_BYTES``.

``DISPATCH_COUNTS`` counts searches issued per backend by ``Index``, and
the replays of a captured search (one a served batch).

:class:`GraphCache` is the GPU form of the reference's ``CompileCache``:
one ``torch.cuda.CUDAGraph`` per query-block shape of an index's search
(:class:`SearchGraph`), replayed with one host call.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import partial_reduce as kernels
from repro_torch.search.metrics import get_metric
from repro_torch.search.quant import unpack_int4_rows
from repro_torch.search.stages import (
    finalize_values,
    merge_topk,
    pad_queries_to,
    prune_candidates,
    rescore_candidates,
    scan_candidates,
    score_gathered,
    score_rows,
    sentinelize_masked,
)
from repro_torch.search import telemetry

__all__ = [
    "DISPATCH_COUNTS",
    "GATHER_BUDGET_BYTES",
    "GraphCache",
    "SearchGraph",
    "cluster_search",
    "cluster_search_quant",
    "cuda_search_packed",
    "cuda_search_packed_quant",
    "default_backend",
    "dense_search",
    "dense_search_quant",
]

# backend name -> searches issued by Index (one per query block) and
# replays of a captured search.
DISPATCH_COUNTS = telemetry.AtomicCounter()
telemetry.registry().register_counter_dict(
    "repro_dispatches_total", DISPATCH_COUNTS, "backend",
    "device dispatches per backend (one per coalesced batch)",
)

# The pruned scan gathers (m, S, d_pad) rows widened to f32 for a chunk of
# m queries; the chunks are cut so that this block stays under 1 GiB (at
# the Sift1M plan, S = 54,800 slots of 128 lanes: 38 queries a chunk).
GATHER_BUDGET_BYTES = 1 << 30


def default_backend(device) -> str:
    """Resolve backend="auto": the CUDA kernels for a CUDA device, the
    plain PyTorch path otherwise."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


class SearchGraph:
    """One captured search: a CUDA graph that reads the static query block
    ``queries`` (M, D) in the compute dtype and writes the static
    ``values`` and ``indices`` (M, k).  ``launches`` and ``plain_calls``
    are what the kernels' counters (``kernels.partial_reduce.LAUNCHES``,
    ``PLAIN_CALLS``) gained while it was captured: the kernels the graph
    holds."""

    def __init__(self, graph, queries: torch.Tensor, values: torch.Tensor,
                 indices: torch.Tensor, launches: dict, plain_calls: dict):
        self.graph = graph
        self.queries = queries
        self.values = values
        self.indices = indices
        self.launches = launches
        self.plain_calls = plain_calls


def capture_search(search: Callable[[torch.Tensor], Tuple[torch.Tensor, ...]],
                   m: int, d: int, dtype: torch.dtype,
                   device: torch.device) -> SearchGraph:
    """Capture ``search`` on an (m, d) block of ``dtype`` rows.

    One eager call first, on a side stream (it builds and loads the
    kernels' library and sets their shared-memory attributes, which a
    capture must not do), then the capture.  A capture that fails raises:
    nothing falls back to eager dispatch.  ``thread_local`` capture
    leaves other threads (submitters, a mutation) free to call CUDA."""
    queries = torch.zeros((m, d), dtype=dtype, device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        search(queries)
    torch.cuda.current_stream(device).wait_stream(side)
    before = (dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        values, indices = search(queries)

    def gained(counter, old):
        return {k: v - old.get(k, 0) for k, v in counter.items()
                if v != old.get(k, 0)}
    return SearchGraph(graph, queries, values, indices,
                       gained(kernels.LAUNCHES, before[0]),
                       gained(kernels.PLAIN_CALLS, before[1]))


class GraphCache:
    """Captured searches of one index, keyed by the block's shape and the
    operands the graphs read (the GPU form of the reference's
    ``CompileCache``).

    ``get(signature, m, dtype, capture)`` returns the graph of an (m, D)
    block of ``dtype`` queries, capturing it with ``capture()`` on a miss.
    ``signature`` holds the ``data_ptr()`` of every operand a graph reads
    and the statics baked into it (``k_scan``, ``n``, ``bin_size``): a
    mutation that reallocates or rebinds any of them gives a new
    signature, which drops every graph of the old one (after a device
    synchronize: a replay in flight may still read them), so the next
    batch recaptures.  A patch made in place keeps the graphs.
    ``info()`` has the reference's ``hits``/``misses``/``entries`` and the
    ``captures``, ``replays`` and ``invalidations`` of the graphs.
    """

    def __init__(self):
        self._graphs: Dict[tuple, SearchGraph] = {}
        self._signature: Optional[tuple] = None
        self.hits = self.misses = self.captures = 0
        self.replays = self.invalidations = 0

    def get(self, signature: tuple, m: int, dtype: torch.dtype,
            capture: Callable[[], SearchGraph]) -> SearchGraph:
        if signature != self._signature:
            if self._graphs:
                torch.cuda.synchronize()
                self._graphs.clear()
                self.invalidations += 1
            self._signature = signature
        key = (m, dtype)
        entry = self._graphs.get(key)
        if entry is None:
            self.misses += 1
            entry = self._graphs[key] = capture()
            self.captures += 1
        else:
            self.hits += 1
        return entry

    def replay(self, entry: SearchGraph) -> None:
        """Launch ``entry``'s captured work on the current stream."""
        entry.graph.replay()
        self.replays += 1

    def info(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._graphs), "captures": self.captures,
                "replays": self.replays, "invalidations": self.invalidations}


def dense_search(
    queries: torch.Tensor,
    database: torch.Tensor,
    row_bias: Optional[torch.Tensor] = None,
    *,
    metric: str = "mips",
    k: int = 10,
    recall_target: float = 0.95,
    reduction_input_size_override: int = -1,
    aggregate_to_topk: bool = True,
    use_bitonic: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain search: full (M, N) score tile + approx_max_k (paper
    Listings 1/2).  ``database`` is metric-prepared; ``row_bias`` carries
    the metric bias and tombstones.  :func:`dense_search_quant` without a
    scale or a rescore tail."""
    return dense_search_quant(
        queries, database, row_bias, None, None, None, metric=metric, k=k,
        k_scan=k, recall_target=recall_target,
        reduction_input_size_override=reduction_input_size_override,
        aggregate_to_topk=aggregate_to_topk, use_bitonic=use_bitonic,
    )


def cuda_search_packed(
    queries: torch.Tensor,
    database: torch.Tensor,
    row_bias: torch.Tensor,
    *,
    metric: str,
    k: int,
    n: int,
    bin_size: int,
    aggregate_to_topk: bool = True,
    use_bitonic: bool = False,
    fused_select: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel search over packed f32 operands (steady-state path).

    ``database`` (n_pad, d_pad) and ``row_bias`` (1, n_pad) satisfy the
    kernels' tiling contract (``repro_torch.search.packed``); ``n`` is
    the logical row space.  Masked result entries pair MASK_VALUE with the
    sentinel index -1 on both paths.  :func:`cuda_search_packed_quant`
    without a scale or a rescore tail.
    """
    return cuda_search_packed_quant(
        queries, database, row_bias, None, None, None, metric=metric, k=k,
        k_scan=k, n=n, bin_size=bin_size, aggregate_to_topk=aggregate_to_topk,
        use_bitonic=use_bitonic, fused_select=fused_select,
    )


def dense_search_quant(
    queries: torch.Tensor,
    database: torch.Tensor,
    row_bias: Optional[torch.Tensor],
    scale: Optional[torch.Tensor],
    rescore_db: Optional[torch.Tensor],
    rescore_bias: Optional[torch.Tensor],
    *,
    metric: str,
    k: int,
    k_scan: int,
    recall_target: float = 0.95,
    reduction_input_size_override: int = -1,
    aggregate_to_topk: bool = True,
    use_bitonic: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain search over any tier: the score tile of the stored rows
    (``* scale`` for int8/int4, ``+ row_bias``, the bias of the stored
    values), then with a rescore tail the bins planned for ``k_scan`` and
    the exact rescore; without one, the scan's top-k."""
    m = get_metric(metric)
    q = m.prepare_queries(queries)
    scores = score_rows(q, database, row_bias, scale)
    if rescore_db is not None:
        vals, idxs = scan_candidates(
            scores, k_scan, recall_target=recall_target,
            reduction_input_size_override=reduction_input_size_override,
            aggregate_to_topk=False,
        )
        vals, idxs = rescore_candidates(
            q, vals, idxs, rescore_db, rescore_bias, k, k_scan, use_bitonic
        )
    else:
        vals, idxs = scan_candidates(
            scores, k, recall_target=recall_target,
            reduction_input_size_override=reduction_input_size_override,
            aggregate_to_topk=aggregate_to_topk, use_bitonic=use_bitonic,
        )
    return finalize_values(vals, m.negate_output), idxs


def cuda_search_packed_quant(
    queries: torch.Tensor,
    database: torch.Tensor,
    row_bias: torch.Tensor,
    scale: Optional[torch.Tensor],
    rescore_db: Optional[torch.Tensor],
    rescore_bias: Optional[torch.Tensor],
    *,
    metric: str,
    k: int,
    k_scan: int,
    n: int,
    bin_size: int,
    aggregate_to_topk: bool = True,
    use_bitonic: bool = False,
    fused_select: bool = False,
    int4_packed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel search over packed operands of any tier.

    The kernels stream the stored rows (``int4_packed``: nibble pairs of
    stored width d_pad / 2) and apply ``scale``; the over-fetched winners
    are then re-scored exactly against ``rescore_db``/``rescore_bias``.
    The branches are the reference's: fused with rescore (the kernel's
    top-``k_scan`` feeds the rescore), fused without rescore (top-``k``),
    and two-pass with ``sentinelize_masked``, then rescore or
    ``merge_topk``.
    """
    m_obj = get_metric(metric)
    q = m_obj.prepare_queries(queries)
    if fused_select and (rescore_db is not None or aggregate_to_topk):
        vals, idxs = kernels.partial_reduce_fused(
            q, database, row_bias, scale,
            k_scan=k_scan if rescore_db is not None else k,
            bin_size=bin_size, int4_packed=int4_packed,
        )
        if rescore_db is not None:
            vals, idxs = rescore_candidates(
                q, vals, idxs, rescore_db, rescore_bias, k, k_scan, use_bitonic
            )
        return finalize_values(vals, m_obj.negate_output), idxs
    vals, idxs = kernels.partial_reduce_packed(
        q, database, row_bias, scale, bin_size=bin_size,
        int4_packed=int4_packed,
    )
    idxs = sentinelize_masked(vals, idxs, n)
    if rescore_db is not None:
        vals, idxs = rescore_candidates(
            q, vals, idxs, rescore_db, rescore_bias, k, k_scan, use_bitonic
        )
    elif aggregate_to_topk:
        vals, idxs = merge_topk(vals, idxs, k, use_bitonic=use_bitonic)
    return finalize_values(vals, m_obj.negate_output), idxs


def cluster_search(
    queries: torch.Tensor,
    database: torch.Tensor,
    row_bias: torch.Tensor,
    centroids: torch.Tensor,
    centroid_bias: torch.Tensor,
    cluster_rows: torch.Tensor,
    spill_rows: torch.Tensor,
    *,
    metric: str,
    k: int,
    probes: int,
    target_scan: float,
    aggregate_to_topk: bool = True,
    use_bitonic: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster-pruned search over a packed f32-tier layout:
    :func:`cluster_search_quant` without a scale or a rescore tail."""
    return cluster_search_quant(
        queries, database, row_bias, None, None, None, centroids,
        centroid_bias, cluster_rows, spill_rows, metric=metric, k=k, k_scan=k,
        probes=probes, target_scan=target_scan,
        aggregate_to_topk=aggregate_to_topk, use_bitonic=use_bitonic,
    )


def cluster_search_quant(
    queries: torch.Tensor,
    database: torch.Tensor,
    row_bias: torch.Tensor,
    scale: Optional[torch.Tensor],
    rescore_db: Optional[torch.Tensor],
    rescore_bias: Optional[torch.Tensor],
    centroids: torch.Tensor,
    centroid_bias: torch.Tensor,
    cluster_rows: torch.Tensor,
    spill_rows: torch.Tensor,
    *,
    metric: str,
    k: int,
    k_scan: int,
    probes: int,
    target_scan: float,
    aggregate_to_topk: bool = True,
    use_bitonic: bool = False,
    int4_packed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster-pruned search over any tier and either packed layout.

    Scores the centroids, gathers the top-``probes`` clusters' rows and
    the spill block (``stages.prune_candidates``; ``int4_packed`` rows
    are unpacked from their nibble pairs as the scan kernel does), scores
    them widened to f32 (``stages.score_gathered``) and reduces the S
    candidates at the planner's ``target_scan``; with a rescore tail the
    bins are planned for ``k_scan`` and the candidates rescored exactly.
    Returned ids are user row ids (the slot tables hold them).  Each chunk
    of queries is independent; a chunk's gather stays within
    ``GATHER_BUDGET_BYTES``.
    """
    m_obj = get_metric(metric)
    q = m_obj.prepare_queries(queries)
    width = database.shape[1] * (2 if int4_packed else 1)
    slots = probes * cluster_rows.shape[1] + spill_rows.shape[0]
    chunk = max(1, GATHER_BUDGET_BYTES // (4 * slots * width))
    out_v, out_i = [], []
    for s in range(0, max(q.shape[0], 1), chunk):
        qc = q[s : s + chunk]
        idc, valid = prune_candidates(qc, centroids, centroid_bias,
                                      cluster_rows, spill_rows, probes)
        rows = database[idc.long()]                    # (m, S, stored width)
        if int4_packed:
            rows = unpack_int4_rows(rows)
        scores = score_gathered(pad_queries_to(qc, width),
                                rows.to(torch.float32), row_bias, idc, valid,
                                scale)
        if rescore_db is not None:
            vals, pos = scan_candidates(scores, k_scan, recall_target=target_scan,
                                        aggregate_to_topk=False)
            idxs = torch.gather(idc, -1, pos.long())
            vals, idxs = rescore_candidates(qc, vals, idxs, rescore_db,
                                            rescore_bias, k, k_scan, use_bitonic)
        else:
            vals, pos = scan_candidates(
                scores, k, recall_target=target_scan,
                aggregate_to_topk=aggregate_to_topk, use_bitonic=use_bitonic,
            )
            idxs = torch.gather(idc, -1, pos.long())
        out_v.append(vals)
        out_i.append(idxs)
    return (finalize_values(torch.cat(out_v), m_obj.negate_output),
            torch.cat(out_i))
