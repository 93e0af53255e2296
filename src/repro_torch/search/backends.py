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
  * :func:`cuda_search` — the same over a raw prepared database (the
    reference's ``pallas_search``, the one-shot functional path): the
    operands padded to the kernels' tiling contract on every call.
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

  * :func:`make_sharded_search_fn` and :func:`sharded_search` — the
    ``"sharded"`` backend (paper §7): the database rows split over a mesh
    of torch devices (``repro_torch.parallel.mesh``), each shard searched
    on its device with that device's path (the kernels on a card, the
    plain path on the CPU), its bins planned for its rows against the
    global N, its ids offset to global ones; the shards' winners are
    gathered to the first device and merged (``stages.merge_topk``, so a
    tie goes to the earlier shard, the lowest global id).

``DISPATCH_COUNTS`` counts searches issued per backend by ``Index``, and
the replays of a captured search (one a served batch).

:class:`GraphCache` is the GPU form of the reference's ``CompileCache``:
one ``torch.cuda.CUDAGraph`` per query-block shape of an index's search
(:class:`SearchGraph`), replayed with one host call.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.binning import plan_bins, round_up
from repro_torch.kernels import partial_reduce as kernels
from repro_torch.search.metrics import get_metric
from repro_torch.search.quant import unpack_int4_rows
from repro_torch.search.stages import (
    MASK_VALUE,
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
    "cuda_search",
    "cuda_search_packed",
    "cuda_search_packed_quant",
    "db_shard_count",
    "default_backend",
    "dense_search",
    "dense_search_quant",
    "make_sharded_search_fn",
    "normalize_db_axes",
    "reset_dispatch_counts",
    "reset_trace_counts",
    "sharded_search",
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


def reset_dispatch_counts() -> None:
    """Zero ``DISPATCH_COUNTS`` (the reference's deprecated alias; prefer
    ``telemetry.reset_all()``)."""
    DISPATCH_COUNTS.clear()


def reset_trace_counts() -> None:
    """Zero the kernels' ``LAUNCHES`` and ``PLAIN_CALLS``: the port's
    record of what a search ran, where the reference counts program traces
    (its deprecated alias; prefer ``telemetry.reset_all()``)."""
    kernels.reset_counts()


def default_backend(device, mesh=None) -> str:
    """Resolve backend="auto": ``"sharded"`` with a mesh attached, the
    CUDA kernels for a CUDA device, the plain PyTorch path otherwise."""
    if mesh is not None:
        return "sharded"
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


def cuda_search(
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
    fused_select: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot kernel search over a raw metric-prepared ``database``
    (N, D) and its additive ``row_bias`` (N,), the operand contract of
    :func:`dense_search`.

    Every call pads the operands to the kernels' tiling contract (D to a
    multiple of 128, N to whole ``max(bin_size, BLOCK_N)`` blocks, the
    bias clamped at ``MASK_VALUE`` and the tail masked), as the
    reference's ``pallas_search`` re-packs inside its program; ``Index``
    packs once instead.  Then :func:`cuda_search_packed`: the fused
    kernel, or the two-pass one where ``fused_select`` is off or every
    bin winner is wanted (``aggregate_to_topk=False``).
    """
    n, d = database.shape
    bin_size = plan_bins(
        n, k, recall_target,
        reduction_input_size_override=reduction_input_size_override,
    ).bin_size
    block_n = max(bin_size, kernels.BLOCK_N)
    n_pad = round_up(max(n, block_n), block_n)
    db = F.pad(database, (0, round_up(d, 128) - d, 0, n_pad - n))
    body = (torch.zeros((n,), dtype=torch.float32, device=database.device)
            if row_bias is None
            else torch.clamp(row_bias.to(torch.float32), min=MASK_VALUE))
    bias = F.pad(body, (0, n_pad - n), value=MASK_VALUE)[None, :]
    return cuda_search_packed(
        queries, db, bias, metric=metric, k=k, n=n, bin_size=bin_size,
        aggregate_to_topk=aggregate_to_topk, use_bitonic=use_bitonic,
        fused_select=fused_select,
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
    vals, idxs = _dense_candidates(
        m.prepare_queries(queries), database, row_bias, scale, rescore_db,
        rescore_bias, k=k, k_scan=k_scan, recall_target=recall_target,
        reduction_input_size_override=reduction_input_size_override,
        aggregate_to_topk=aggregate_to_topk, use_bitonic=use_bitonic)
    return finalize_values(vals, m.negate_output), idxs


def _dense_candidates(q, database, row_bias, scale, rescore_db, rescore_bias,
                      *, k, k_scan, recall_target,
                      reduction_input_size_override, aggregate_to_topk,
                      use_bitonic):
    """:func:`dense_search_quant` on prepared queries, in the internal max
    convention."""
    scores = score_rows(q, database, row_bias, scale)
    if rescore_db is not None:
        vals, idxs = scan_candidates(
            scores, k_scan, recall_target=recall_target,
            reduction_input_size_override=reduction_input_size_override,
            aggregate_to_topk=False,
        )
        return rescore_candidates(
            q, vals, idxs, rescore_db, rescore_bias, k, k_scan, use_bitonic
        )
    return scan_candidates(
        scores, k, recall_target=recall_target,
        reduction_input_size_override=reduction_input_size_override,
        aggregate_to_topk=aggregate_to_topk, use_bitonic=use_bitonic,
    )


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
    vals, idxs = _cuda_candidates(
        m_obj.prepare_queries(queries), database, row_bias, scale, rescore_db,
        rescore_bias, k=k, k_scan=k_scan, n=n, bin_size=bin_size,
        aggregate_to_topk=aggregate_to_topk, use_bitonic=use_bitonic,
        fused_select=fused_select, int4_packed=int4_packed)
    return finalize_values(vals, m_obj.negate_output), idxs


def _cuda_candidates(q, database, row_bias, scale, rescore_db, rescore_bias,
                     *, k, k_scan, n, bin_size, aggregate_to_topk,
                     use_bitonic, fused_select, int4_packed):
    """:func:`cuda_search_packed_quant` on prepared queries, in the
    internal max convention."""
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
        return vals, idxs
    vals, idxs = kernels.partial_reduce_packed(
        q, database, row_bias, scale, bin_size=bin_size,
        int4_packed=int4_packed,
    )
    idxs = sentinelize_masked(vals, idxs, n)
    if rescore_db is not None:
        return rescore_candidates(
            q, vals, idxs, rescore_db, rescore_bias, k, k_scan, use_bitonic
        )
    if aggregate_to_topk:
        return merge_topk(vals, idxs, k, use_bitonic=use_bitonic)
    return vals, idxs


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
    vals, idxs = _cluster_candidates(
        m_obj.prepare_queries(queries), database, row_bias, scale, rescore_db,
        rescore_bias, (centroids, centroid_bias, cluster_rows, spill_rows),
        k=k, k_scan=k_scan, probes=probes, target_scan=target_scan,
        aggregate_to_topk=aggregate_to_topk, use_bitonic=use_bitonic,
        int4_packed=int4_packed)
    return finalize_values(vals, m_obj.negate_output), idxs


def _cluster_candidates(q, database, row_bias, scale, rescore_db, rescore_bias,
                        tables, *, k, k_scan, probes, target_scan,
                        aggregate_to_topk, use_bitonic, int4_packed,
                        offset: int = 0, n_local: Optional[int] = None):
    """:func:`cluster_search_quant` on prepared queries, in the internal
    max convention.  With ``n_local`` the operands are one shard's rows
    ``[offset, offset + n_local)`` (the reference's sharded pruned scan):
    the slots of rows another shard owns are masked like empty ones, the
    gather and the rescore read shard-local rows, and the ids returned
    are global."""
    centroids, centroid_bias, cluster_rows, spill_rows = tables
    width = database.shape[1] * (2 if int4_packed else 1)
    slots = probes * cluster_rows.shape[1] + spill_rows.shape[0]
    chunk = max(1, GATHER_BUDGET_BYTES // (4 * slots * width))
    out_v, out_i = [], []
    for s in range(0, max(q.shape[0], 1), chunk):
        qc = q[s : s + chunk]
        idc, valid = prune_candidates(qc, centroids, centroid_bias,
                                      cluster_rows, spill_rows, probes)
        local = idc
        if n_local is not None:
            local = idc - offset
            valid = valid & (local >= 0) & (local < n_local)
            local = torch.clamp(local, 0, n_local - 1)
        rows = database[local.long()]                  # (m, S, stored width)
        if int4_packed:
            rows = unpack_int4_rows(rows)
        scores = score_gathered(pad_queries_to(qc, width),
                                rows.to(torch.float32), row_bias, local, valid,
                                scale)
        if rescore_db is not None:
            vals, pos = scan_candidates(scores, k_scan, recall_target=target_scan,
                                        aggregate_to_topk=False)
            lsel = torch.gather(local, -1, pos.long())
            vals, idxs = rescore_candidates(qc, vals, lsel, rescore_db,
                                            rescore_bias, k, k_scan, use_bitonic)
            idxs = idxs + offset
        else:
            vals, pos = scan_candidates(
                scores, k, recall_target=target_scan,
                aggregate_to_topk=aggregate_to_topk, use_bitonic=use_bitonic,
            )
            idxs = torch.gather(idc, -1, pos.long())
        out_v.append(vals)
        out_i.append(idxs)
    return torch.cat(out_v), torch.cat(out_i)


# --- the sharded backend (paper §7) ------------------------------------------


def normalize_db_axes(db_axis) -> Tuple[str, ...]:
    """A database-axis spec (``"model"`` or a tuple of mesh axis names) as
    a tuple; the tuple form splits the rows over the product of those
    axes, shards linearized row-major over them."""
    return (db_axis,) if isinstance(db_axis, str) else tuple(db_axis)


def db_shard_count(mesh, db_axis) -> int:
    """Database shards: the product of the mesh extents of every axis the
    rows are split over."""
    count = 1
    for a in normalize_db_axes(db_axis):
        count *= mesh.shape[a]
    return count


class _Tables(NamedTuple):
    """Cluster tables passed as operands (the functional sharded path)."""

    centroids: torch.Tensor
    centroid_bias: torch.Tensor
    cluster_rows: torch.Tensor
    spill_rows: torch.Tensor

    def operands(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self)


def _check_axes(mesh, db_axis, batch_axis) -> Tuple[str, ...]:
    db_axes = normalize_db_axes(db_axis)
    if batch_axis is not None and batch_axis in db_axes:
        raise ValueError(
            f"batch_axis {batch_axis!r} cannot also shard the database "
            f"(db_axis={db_axes!r})"
        )
    for a in db_axes + ((batch_axis,) if batch_axis else ()):
        if a not in mesh.shape:
            raise ValueError(f"axis {a!r} is not in the mesh {dict(mesh.shape)}")
    return db_axes


def _shard_candidates(q, shard, j: int, *, n: int, k: int, k_scan: int,
                      recall_target: float, use_bitonic: bool,
                      fused_select: bool, cluster=None):
    """One shard's winners on its device: prepared queries ``q`` against
    ``shard`` (a PackedState over rows ``[j * n_local, (j + 1) *
    n_local)``), in the internal max convention, with global ids (a
    masked kernel slot keeps -1).  ``cluster``: ``(tables, probes,
    target_scan)`` of the replicated pruning tables."""
    n_local = shard.n
    offset = j * n_local
    ks = min(k_scan, n_local)
    kk = min(k, n_local)
    ops = (q, shard.db, shard.bias, shard.scale, shard.rescore_db,
           shard.rescore_bias)
    if cluster is not None:
        tables, probes, target_scan = cluster
        return _cluster_candidates(
            *ops, tables, k=kk, k_scan=ks, probes=probes,
            target_scan=target_scan, aggregate_to_topk=True,
            use_bitonic=use_bitonic, int4_packed=shard.int4_packed,
            offset=offset, n_local=n_local)
    if shard.backend == "cuda":
        vals, idxs = _cuda_candidates(
            *ops, k=kk, k_scan=ks, n=n_local, bin_size=shard.bin_size,
            aggregate_to_topk=True, use_bitonic=use_bitonic,
            fused_select=fused_select, int4_packed=shard.int4_packed)
    else:
        vals, idxs = _dense_candidates(
            *ops, k=kk, k_scan=ks, recall_target=recall_target,
            reduction_input_size_override=n, aggregate_to_topk=True,
            use_bitonic=use_bitonic)
    return vals, torch.where(idxs >= 0, idxs + offset, idxs)


def sharded_search(
    queries: torch.Tensor,
    state,
    *,
    metric: str,
    k: int,
    k_scan: int,
    recall_target: float,
    batch_groups: int = 1,
    use_bitonic: bool = False,
    fused_select: bool = True,
    probes: Optional[int] = None,
    target_scan: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search a ``packed.ShardedState``: every shard on its device, the
    winners gathered to the first device and merged.

    With ``batch_groups`` > 1 (a ``batch_axis``) the query rows split
    over the groups, each searching its own replicas of the shards; rows
    that do not divide run on the first group (replicated, as the
    reference replicates them).  On several cards each shard's launches
    queue on its device's current stream and the cross-device copies
    order themselves: no host synchronization between shards.
    """
    m_obj = get_metric(metric)
    q = m_obj.prepare_queries(queries)
    home = state.device
    groups = batch_groups if q.shape[0] % batch_groups == 0 else 1
    parts_v, parts_i = [], []
    rows = q.shape[0] // groups
    for g in range(groups):
        qg = q[g * rows : (g + 1) * rows]
        vals, idxs = [], []
        for j in range(len(state.shards)):
            shard = state.replica(g, j)
            dev = shard.db.device
            cl = None
            if state.cluster is not None:
                cl = (state.cluster_operands(dev), probes, target_scan)
            v, i = _shard_candidates(
                qg.to(dev), shard, j, n=state.n, k=k, k_scan=k_scan,
                recall_target=recall_target, use_bitonic=use_bitonic,
                fused_select=fused_select, cluster=cl)
            vals.append(v.to(home))
            idxs.append(i.to(home, torch.int32))
        v, i = merge_topk(torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1), k,
                          use_bitonic=use_bitonic)
        parts_v.append(v)
        parts_i.append(i)
    return (finalize_values(torch.cat(parts_v), m_obj.negate_output),
            torch.cat(parts_i))


def make_sharded_search_fn(
    mesh,
    *,
    metric: str = "mips",
    k: int = 10,
    recall_target: float = 0.95,
    db_axis="model",
    batch_axis: Optional[str] = None,
    use_bitonic: bool = False,
    k_scan: Optional[int] = None,
    cluster_probes: Optional[int] = None,
    cluster_target_scan: Optional[float] = None,
    fused_select: bool = True,
):
    """``(queries, database, row_bias, ...) -> (values, indices)`` over a
    mesh (``repro_torch.parallel.mesh.Mesh``), the reference's signature.

    ``database`` (N, D) holds metric-prepared rows of the logical layout
    (int4 as one code a byte); ``row_bias`` (N,) their fused bias.  Each
    call splits them into the mesh's database shards (N must divide) and
    lays each out for its device (the kernels' padded layout on a card),
    as the reference's one-shot paths re-pack inside their program; an
    ``Index.shard`` lays them out once.  Then :func:`sharded_search`.
    A quantized tier passes ``scale`` and the rescore tail
    ``rescore_db``/``rescore_bias``: each shard rescores its own
    ``k_scan`` winners with shard-local ids before the offset.  The
    cluster tables (``cluster_probes``/``cluster_target_scan`` and the
    four table operands) are replicated: each shard scores only the
    candidate slots it owns.
    """
    from repro_torch.search import packed as packedlib
    from repro_torch.search.spec import SearchSpec

    db_axes = _check_axes(mesh, db_axis, batch_axis)
    grid = mesh.device_grid(db_axes, batch_axis)
    n_shards = len(grid[0])
    scan_k = k if k_scan is None else k_scan

    def searcher(queries, database, row_bias=None, scale=None,
                 rescore_db=None, rescore_bias=None, centroids=None,
                 centroid_bias=None, cluster_rows=None, spill_rows=None):
        n, d = database.shape
        if n % n_shards:
            raise ValueError(
                f"database rows {n} not divisible by {n_shards} shards")
        with_cluster = centroids is not None
        if with_cluster and (cluster_probes is None
                             or cluster_target_scan is None):
            raise ValueError(
                "cluster operands passed but make_sharded_search_fn was "
                "built without cluster_probes/cluster_target_scan")
        # int4 codes held one a byte score as the int8 values they are
        storage = ("int8" if database.dtype == torch.int8 else
                   "bf16" if rescore_db is not None else "f32")
        spec = SearchSpec(metric=metric, k=k, recall_target=recall_target,
                          storage=storage)
        bias = (torch.zeros((n,), dtype=torch.float32, device=database.device)
                if row_bias is None else row_bias.to(torch.float32))
        flat = packedlib.PackedState(
            backend="torch", db=database, bias=bias, n=n, d=d, plan=None,
            bin_size=0, block_n=0, storage=storage, scale=scale,
            rescore_db=rescore_db, rescore_bias=rescore_bias,
            compute_dtype=str(queries.dtype).removeprefix("torch."))
        if with_cluster:
            flat.cluster = _Tables(centroids, centroid_bias, cluster_rows,
                                   spill_rows)
        state = packedlib.ShardedState.split(flat, grid, n, spec, scan_k,
                                             default_backend(grid[0][0]))
        return sharded_search(
            queries.to(state.device), state, metric=metric, k=k,
            k_scan=scan_k, recall_target=recall_target,
            batch_groups=len(grid), use_bitonic=use_bitonic,
            fused_select=fused_select, probes=cluster_probes,
            target_scan=cluster_target_scan)

    return searcher
