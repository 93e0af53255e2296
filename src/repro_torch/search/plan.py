"""Model-driven kernel planner: the paper's performance model as a subsystem.

Port of ``src/repro/search/plan.py``.  ``plan_search`` maps a workload
``(M, N, D, k, metric, storage, recall_target)`` and a hardware profile
(``repro_torch.core.roofline.HARDWARE``) onto a frozen :class:`Plan`:

  * the bin layout ``(L, W)`` from the recall guarantee (Eq. 13–14), and
    the scan's over-fetched ``k_scan`` — both the reference's;
  * the kernel tiles: the CUDA kernels' fixed ``BLOCK_M`` x ``BLOCK_N``
    (``repro_torch.kernels.partial_reduce``; the reference sizes TPU tiles
    against VMEM, which these kernels have no use for);
  * ``query_block``, the rows a plain path scores at a time;
  * the roofline prediction (Eq. 4–6): FLOPs, bytes, COPs, the binding
    wall and the time.  The profiles hold the device's peaks, so the
    predicted time is a bound on the search, never a fit to it.

The ``"cuda"`` backend is priced as the port's own scan runs: the
tensor-core passes of its exact bf16 split (six for f32 rows, three for
the bf16/int8/int4 forms; one for bf16 queries, ``dtype="bfloat16"``)
over d rounded up to 16, the stored rows with their bias (and scale)
read once, and the instructions a score its function needs (the bias,
the bin's winner).  The ``"torch"`` backend is priced as the reference
prices its ``"xla"`` path (the unfused score matrix).  With ``cluster="auto"`` the planner evaluates the
cluster-pruned scan (:func:`plan_clusters`); where it is enabled, the
gathered scan's cost (:func:`_cluster_cost`, the reference's) replaces
the scan's on every backend and profile.

``Index.build(..., plan="measure")`` refines the model's plan with a
short timed sweep (:func:`tune_plan`), kept in a :class:`PlanCache`;
``Index.explain()`` reports the plan with its predicted and, on request,
measured time.

>>> p = plan_search(n=1_000_000, d=128, k=10, m=10_000, metric="l2",
...                 backend="cuda", device="h100")
>>> p.num_bins, p.bin_size, p.block_m, p.bottleneck
(245, 4096, 128, 'compute')
>>> round(p.predicted_s * 1e3, 2)   # six bf16 passes at 989.4 TFLOP/s
15.58
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.binning import BinPlan, plan_bins, round_up
from repro_torch.core.roofline import (
    HARDWARE,
    KernelCost,
    attainable_flops,
    bottleneck,
)
from repro_torch.kernels import partial_reduce as kernels
from repro_torch.search import cluster as clusterlib
from repro_torch.search import quant
from repro_torch.search.spec import SearchSpec, check_tiles

__all__ = [
    "CLUSTER_GATHER_PENALTY",
    "CLUSTER_SPEEDUP_BAR",
    "DEFAULT_QUERY_BLOCK",
    "MIN_SERVE_BUCKET",
    "SCORE_TILE_BUDGET",
    "Plan",
    "PlanCache",
    "SEGMENT_ALIGN",
    "detect_device",
    "hlo_check",
    "plan_buckets",
    "plan_clusters",
    "plan_search",
    "plan_segments",
    "time_search",
    "tune_plan",
]

DEFAULT_QUERY_BLOCK = 4096

# A plain path materializes a (query_block, N) f32 score tile; the planner
# keeps it under this many bytes.
SCORE_TILE_BUDGET = 64 * 2**20

# Smallest serving micro-batch of the bucket ladder (plan_buckets).
MIN_SERVE_BUCKET = 8

# Host-tier segment rows round up to this multiple, so that capacity
# growth (Index.add) lands on whole waves (the reference's).
SEGMENT_ALIGN = 1024

# Cluster pruning's cost model (the reference's): a gathered candidate row
# is priced at this multiple of a streamed one when deciding the
# crossover, and pruning is enabled only when the modeled row cost beats
# the full scan by CLUSTER_SPEEDUP_BAR.
CLUSTER_GATHER_PENALTY = 4.0
CLUSTER_SPEEDUP_BAR = 2.0

# The port's pruned scan (backends.cluster_search_quant) writes each
# query's gathered rows as an (m, S, width) f32 block (4 bytes an element),
# then scores it in a fixed order (stages.dot_rows): the products read it
# and write a block (8), the halving adds read twice and write once what
# they sum (12).  24 bytes a gathered element beyond the stored read that
# the reference's cost counts (its XLA program fuses the gather into the
# dot).
_GATHER_COPY_BYTES = 24.0

_DTYPE_BYTES = {
    "float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
    "float64": 8, "f32": 4, "bf16": 2,
}

# The port's scan kernel (csrc/partial_reduce.cu), by stored form: the
# tensor-core passes of its exact bf16 split (three query parts against
# the stored rows; f32 rows are split in three as well, six products).
# The CUDA-core instructions per score are what the scan's function needs
# whatever the kernel: one add of the bias (one FFMA with the scale), one
# compare and two selects to keep the bin's winner.  The kernel's own
# epilogue takes more (its shuffle butterfly); that is not part of a bound.
_SPLIT_PASSES = {"f32": 6, "bf16": 3, "int8": 3, "int4": 3}
_SCORE_INSTR = 4

# SMs of the H100 SXM (torch.cuda.get_device_properties on the card),
# for the kernels' split count a plan on the "h100" profile reports.
_H100_SMS = 132

_CACHE_ENV = "REPRO_TORCH_PLAN_CACHE"


def _dtype_bytes(dtype: Optional[str]) -> int:
    if dtype is None:
        return 4
    return _DTYPE_BYTES.get(str(dtype), 4)


def detect_device(name: Optional[str] = None, *, device=None) -> str:
    """Resolve a hardware-profile name against ``HARDWARE``.

    ``None`` describes the torch ``device`` (default: the first CUDA
    device if there is one, else the CPU): an H100 maps onto ``"h100"``,
    any other CUDA device onto the reference's ``"a100"``, the CPU onto
    ``"cpu"``.

    >>> detect_device("h100"), detect_device(device="cpu")
    ('h100', 'cpu')
    """
    if name is not None:
        if name not in HARDWARE:
            raise ValueError(
                f"unknown device profile {name!r}; known: {sorted(HARDWARE)}"
            )
        return name
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return "h100" if "H100" in torch.cuda.get_device_name(device) else "a100"


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel configuration of one search workload, with the roofline
    prediction behind it (Eq. 4–10).

    Workload: ``m`` (query batch; 0 = unknown, the prediction then
    assumes one ``query_block``), ``n`` rows, ``d`` dims, ``k``,
    ``metric``, ``dtype``, ``recall_target``, ``backend`` (``"torch"`` or
    ``"cuda"``), ``device`` (the hardware profile's name).

    Layout: ``num_bins``/``log2_bin_size``/``padded_n`` (Eq. 13–14),
    ``d_pad``, the kernel tiles ``block_m``/``block_n``, ``query_block``,
    ``stream``.

    Prediction, for one search of ``m`` queries (one ``query_block`` if
    ``m`` is 0): ``flops``, ``hbm_bytes``, ``cops``, ``i_mem``,
    ``i_cop``, ``attainable_flops``, the binding ``bottleneck`` wall,
    ``predicted_s`` and ``predicted_qps``.

    ``cluster``: None for ``cluster="off"``, else the
    ``cluster.ClusterPlan`` that ``cluster="auto"`` derived (``enabled``
    False where the crossover rejected pruning, or where the ``"h100"``
    profile vetoed it); enabled, the prediction is the pruned scan's and
    ``expected_recall`` the collision x miss product.
    ``cluster_price``: ``(pruned_s, dense_s)``, the two predicted times,
    wherever the ``"h100"`` profile priced a plan the crossover enabled,
    dropped or kept (a restored index keeps its tables and reports their
    price); ``cluster_veto`` is that price where the plan was dropped,
    else None.

    Sharded (``backend="sharded"``, the reference's fields):
    ``db_shards``, the database shard count; the scan is priced for one
    shard's rows (the shards run at once), and ``ici_bytes``/``ici_s``
    price the one gather of the shards' (f32 value, int32 id) winners at
    the profile's ``ici_bandwidth``; both 0 with one shard.  The port
    adds ``shards_per_device`` (the shards the busiest device holds) and
    ``db_devices`` (the distinct devices holding shards): on the
    ``"h100"`` profile the busiest device scans its shards one after
    another, and the gather is priced as one block of winners from each
    device (none when one device holds them all).

    Host tier (``residency="host"``, the reference's fields): the
    segment-wave schedule — ``segment_rows`` a wave, ``num_segments``
    waves a search, two segments on the device at once inside
    ``hbm_budget_bytes``; all 0 for ``"hbm"``.

    ``source`` is ``"model"``, ``"measure"`` (refined by
    :func:`tune_plan`) or ``"user"`` (every tile field pinned).
    """

    # workload
    m: int
    n: int
    d: int
    k: int
    metric: str
    dtype: str
    recall_target: float
    backend: str
    device: str
    # bin layout (Eq. 13-14)
    num_bins: int
    log2_bin_size: int
    padded_n: int
    expected_recall: float
    # kernel layout
    d_pad: int
    block_m: int
    block_n: int
    query_block: int
    stream: bool
    # roofline prediction (Eq. 4-10)
    flops: float
    hbm_bytes: float
    cops: float
    i_mem: float
    i_cop: float
    attainable_flops: float
    bottleneck: str
    predicted_s: float
    predicted_qps: float
    source: str = "model"
    reduction_input_size_override: int = -1
    storage: str = "f32"
    rescore: bool = False
    k_scan: int = 0
    cluster: Optional[clusterlib.ClusterPlan] = None
    cluster_price: Optional[Tuple[float, float]] = None
    db_shards: int = 1
    ici_bytes: float = 0.0
    ici_s: float = 0.0
    shards_per_device: int = 1
    db_devices: int = 1
    residency: str = "hbm"
    segment_rows: int = 0
    num_segments: int = 0
    hbm_budget_bytes: float = 0.0

    @property
    def bin_size(self) -> int:
        return 1 << self.log2_bin_size

    @property
    def cluster_veto(self) -> Optional[Tuple[float, float]]:
        """``cluster_price`` where the ``"h100"`` profile dropped the plan
        the crossover enabled, else None."""
        if self.cluster_price is None or self.cluster.enabled:
            return None
        return self.cluster_price

    @property
    def bin_plan(self) -> BinPlan:
        """The recall-guarantee layout as a ``BinPlan``."""
        return BinPlan(
            n=self.n, k=self.k, num_bins=self.num_bins,
            log2_bin_size=self.log2_bin_size, padded_n=self.padded_n,
            expected_recall=self.expected_recall,
        )

    @property
    def splits(self) -> Optional[int]:
        """The CUDA kernels' split of the rows for this plan's batch
        (``kernels.split_plan``) on the ``"h100"`` profile; None for the
        ``"torch"`` backend or another profile."""
        if self.backend != "cuda" or self.device != "h100":
            return None
        n_pad = _cuda_rows(self.n, self.bin_size)
        return kernels.split_plan(self.m or self.query_block, n_pad,
                                  self.bin_size, _H100_SMS, self.k_scan)[1]

    def to_spec(self, base: Optional[SearchSpec] = None) -> SearchSpec:
        """A concrete ``SearchSpec`` from this plan; fields the ``base``
        spec already pins win over the plan, and ``serve_buckets``
        defaults to the ladder of the ``query_block``
        (:func:`plan_buckets`), as in the reference."""
        base = base or SearchSpec(
            metric=self.metric, k=self.k, recall_target=self.recall_target,
            backend=self.backend, storage=self.storage, rescore=self.rescore,
            residency=self.residency,
        )
        return dataclasses.replace(
            base,
            block_m=base.block_m or self.block_m,
            max_block_n=base.max_block_n or self.block_n,
            query_block=base.query_block or self.query_block,
            serve_buckets=base.serve_buckets
            or plan_buckets(base.query_block or self.query_block),
            segment_rows=base.segment_rows or (self.segment_rows or None),
        )

    def summary(self) -> dict:
        """Flat dict view (what ``Index.explain()`` embeds), with the
        ``bin_size`` and the kernels' ``splits``; the reference's keys
        (``cluster_price`` is reported in ``explain()``'s cluster
        block, ``shards_per_device`` and ``db_devices`` in its sharding
        block)."""
        out = dataclasses.asdict(self)
        for key in ("cluster_price", "shards_per_device", "db_devices"):
            del out[key]
        out["bin_size"] = self.bin_size
        out["splits"] = self.splits
        return out


def _cuda_rows(n: int, bin_size: int) -> int:
    """Rows the CUDA layout scans: n padded to a multiple of
    max(bin_size, BLOCK_N) (``packed._layout``)."""
    block_n = max(bin_size, kernels.BLOCK_N)
    return round_up(max(n, block_n), block_n)


def _cuda_cost(m: int, n: int, d: int, bin_size: int, k_scan: int,
               storage: str, dtype_bytes: int = 4) -> KernelCost:
    """Cost of the port's fused CUDA scan for ``m`` queries.

    FLOPs  = passes * 2 * M * n_pad * d16 (the tensor-core work: the
             split's passes for f32 queries, one for bf16 queries)
    bytes  = dtype_bytes MD + n_pad * (row bytes + bias [+ scale])
             + 8 M k_scan
    COPs   = the function's instructions per score * M * n_pad

    With bf16 compute (``dtype_bytes`` 2) the f32 tier stores bf16 rows.
    """
    form = "bf16" if storage == "f32" and dtype_bytes == 2 else storage
    n_pad = _cuda_rows(n, bin_size)
    d16 = round_up(d, 16)
    row_bytes = round_up(d, 128) * quant.storage_bytes(form)
    side = 8.0 if form in ("int8", "int4") else 4.0
    passes = 1 if dtype_bytes == 2 else _SPLIT_PASSES[form]
    flops = passes * 2.0 * m * n_pad * d16
    hbm = (dtype_bytes * m * d + n_pad * (row_bytes + side)
           + 8.0 * m * k_scan)
    cops = _SCORE_INSTR * m * n_pad
    return KernelCost(flops=flops, hbm_bytes=hbm, cops=cops)


def _dense_cost(m: int, n: int, d: int, l: int, dtype_bytes: int,
                db_bytes: Optional[float] = None) -> KernelCost:
    """Cost of the unfused plain path (Remark 1): operand reads, the full
    (M, N) f32 score matrix written and read, and the bin winners."""
    if db_bytes is None:
        db_bytes = dtype_bytes
    flops = 2.0 * m * n * d
    hbm = (
        dtype_bytes * m * d + db_bytes * n * d
        + 4.0 * (2.0 * m * n + 2.0 * m * l)
    )
    cops = float(m) * n  # the reduction's compare chain
    return KernelCost(flops=flops, hbm_bytes=hbm, cops=cops)


def _rescore_cost(m: int, l: int, k_scan: int, d: int) -> KernelCost:
    """Added cost of the exact second pass of a quantized tier: the
    ``k_scan`` candidates' f32 rows gathered and scored."""
    flops = 2.0 * m * k_scan * d
    hbm = 4.0 * (m * k_scan * d + 3.0 * m * k_scan)  # rows + bias/vals/idxs
    cops = float(m) * (l + k_scan)  # the cut + the exact compare chain
    return KernelCost(flops=flops, hbm_bytes=hbm, cops=cops)


def plan_clusters(*, n: int, k_scan: int,
                  recall_target: float) -> clusterlib.ClusterPlan:
    """The cluster-pruning parameters and the enable decision (the
    reference's): the geometry from ``cluster``'s closed forms, and
    pruning enabled only where C centroid dots plus
    ``CLUSTER_GATHER_PENALTY`` x S gathered rows beat the full scan's N
    by ``CLUSTER_SPEEDUP_BAR``, the probes stay below C, and the S
    scanned slots are fewer than N and at least 4 ``k_scan``.

    >>> plan_clusters(n=8192, k_scan=10, recall_target=0.95).enabled
    True
    >>> plan_clusters(n=2048, k_scan=10, recall_target=0.95).enabled
    False
    >>> cp = plan_clusters(n=1_000_000, k_scan=10, recall_target=0.95)
    >>> cp.num_clusters, cp.rows_per_cluster, cp.probes, cp.spill_capacity
    (1024, 1224, 32, 15632)
    """
    num_clusters = clusterlib.num_clusters_for(n)
    rows_per_cluster = clusterlib.rows_per_cluster_for(n, num_clusters)
    probes = clusterlib.probes_for(recall_target, num_clusters)
    spill = clusterlib.spill_capacity_for(n)
    budget = clusterlib.miss_budget_for(recall_target)
    # the inner scan's target, so that collision x miss meets the target
    target_scan = recall_target / (1.0 - budget)
    scan_rows = probes * rows_per_cluster + spill
    speedup = n / (num_clusters + CLUSTER_GATHER_PENALTY * scan_rows)
    enabled = (
        speedup >= CLUSTER_SPEEDUP_BAR
        and probes < num_clusters
        and scan_rows < n
        and scan_rows >= 4 * k_scan
    )
    return clusterlib.ClusterPlan(
        n=n, num_clusters=num_clusters, rows_per_cluster=rows_per_cluster,
        probes=probes, spill_capacity=spill, miss_budget=budget,
        target_scan=target_scan, predicted_speedup=speedup, enabled=enabled,
    )


def _cluster_cost(m: int, d: int, l: int, cp: clusterlib.ClusterPlan,
                  dtype_bytes: int, db_bytes: float) -> KernelCost:
    """Cost of the pruned gathered scan (the reference's): C centroid dots
    and S gathered rows a query, with no reuse across queries, then the
    (m, S) score tile and its bin winners."""
    c, s = cp.num_clusters, cp.scan_rows
    flops = 2.0 * m * (c + s) * d
    hbm = (
        dtype_bytes * m * d                    # queries
        + 4.0 * c * d + 4.0 * c               # centroid table + bias
        + 4.0 * m * s                          # gathered candidate ids
        + db_bytes * m * s * d                 # gathered rows, no reuse
        + 4.0 * (2.0 * m * s + 2.0 * m * l)    # score tile + bin winners
    )
    cops = float(m) * (c + s)
    return KernelCost(flops=flops, hbm_bytes=hbm, cops=cops)


def _card_cluster_cost(m: int, d: int, l: int, cp: clusterlib.ClusterPlan,
                       dtype_bytes: int, db_bytes: float,
                       width: int) -> KernelCost:
    """The pruned scan as the port runs it on the card: the reference's
    cost (:func:`_cluster_cost`) plus the traffic of the gathered rows' f32
    blocks of ``width`` lanes (``_GATHER_COPY_BYTES``)."""
    cost = _cluster_cost(m, d, l, cp, dtype_bytes, db_bytes)
    copy = _GATHER_COPY_BYTES * m * cp.scan_rows * width
    return KernelCost(flops=cost.flops, hbm_bytes=cost.hbm_bytes + copy,
                      cops=cost.cops)


def _cluster_veto(pruned: KernelCost, dense: KernelCost, hw,
                  pin: Optional[bool]) -> Tuple[Tuple[float, float], bool]:
    """The ``"h100"`` profile's price of a cluster plan the crossover
    enabled and its decision: ``((pruned_s, dense_s), drop)``, the two
    predicted times and whether the plan is dropped.  ``pin`` is an
    index's decision at build time (or a restored index's tables), kept
    whatever the batch (True: dropped, False: kept); None decides here:
    dropped where the pruned scan is priced at least as high as the dense
    scan."""
    pruned_s = pruned.flops / attainable_flops(pruned, hw)
    dense_s = dense.flops / attainable_flops(dense, hw)
    return (pruned_s, dense_s), (pruned_s >= dense_s if pin is None else pin)


def plan_buckets(
    max_batch: int, *, min_bucket: int = MIN_SERVE_BUCKET
) -> Tuple[int, ...]:
    """Micro-batch bucket ladder: doubling from ``min_bucket`` up to
    ``max_batch``, which is always the last rung.

    >>> plan_buckets(64)
    (8, 16, 32, 64)
    >>> plan_buckets(100)
    (8, 16, 32, 64, 100)
    >>> plan_buckets(4)
    (4,)
    """
    if max_batch <= 0:
        raise ValueError(f"max_batch must be positive, got {max_batch}")
    if min_bucket <= 0:
        raise ValueError(f"min_bucket must be positive, got {min_bucket}")
    out = []
    b = min(min_bucket, max_batch)
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def _plan_query_block(n: int, backend: str = "torch") -> int:
    """Rows a plain path scores at a time: the largest power of two (at
    least 8, at most ``DEFAULT_QUERY_BLOCK``) whose (rows, N) f32 score
    tile fits ``SCORE_TILE_BUDGET`` (the reference's rule for its XLA
    path).  Both port backends run plain paths on the CPU; the CUDA
    kernels take any M in one call and ignore it.  The sharded backend
    keeps the default, as the reference's does: its tile is (rows,
    N / shards) a shard, and the shard count is not known here."""
    if backend == "sharded":
        return DEFAULT_QUERY_BLOCK
    qb = SCORE_TILE_BUDGET // max(1, 4 * n)
    if qb >= DEFAULT_QUERY_BLOCK:
        return DEFAULT_QUERY_BLOCK
    return 1 << max(3, int(math.floor(math.log2(max(8, qb)))))


def plan_segments(
    *,
    n: int,
    d: int,
    db_bytes: float,
    hbm_budget_bytes: float,
    rescore: bool = False,
    segment_rows: Optional[int] = None,
) -> Tuple[int, int]:
    """Host-tier segment schedule: ``(segment_rows, num_segments)`` (the
    reference's).

    Two segments are on the device at once — the wave being scanned and
    the copy of the next — so one segment must fit in half of
    ``hbm_budget_bytes``.  A segment row costs its stored width plus the
    per-row bias and scale, plus the f32 rescore tail where the quantized
    two-pass runs.  Rows round down to ``SEGMENT_ALIGN`` (at least one
    ``SEGMENT_ALIGN``), and ``segment_rows * num_segments >= n``:
    ``Index.build`` pads capacity to that product.  An explicit
    ``segment_rows`` pins the wave (the budget is not checked).

    >>> plan_segments(n=4096, d=128, db_bytes=4, hbm_budget_bytes=2**20)
    (1024, 4)
    """
    if n <= 0:
        raise ValueError(f"need positive n, got {n}")
    per_row = float(d * db_bytes) + 8.0            # stored row + bias/scale
    if rescore:
        per_row += 4.0 * d + 4.0                   # f32 rescore tail + bias
    if segment_rows is None:
        if hbm_budget_bytes <= 0:
            raise ValueError(
                f"hbm_budget_bytes must be positive, got {hbm_budget_bytes}"
            )
        fit = int(hbm_budget_bytes / 2.0 / per_row)
        segment_rows = max(
            SEGMENT_ALIGN, (fit // SEGMENT_ALIGN) * SEGMENT_ALIGN
        )
    num_segments = -(-n // segment_rows)
    return segment_rows, num_segments


def plan_search(
    *,
    n: int,
    d: int,
    k: int,
    m: Optional[int] = None,
    metric: str = "mips",
    recall_target: float = 0.95,
    dtype: Optional[str] = None,
    backend: str = "torch",
    device: Optional[str] = None,
    reduction_input_size_override: int = -1,
    block_m: Optional[int] = None,
    max_block_n: Optional[int] = None,
    query_block: Optional[int] = None,
    storage: str = "f32",
    rescore: Optional[bool] = None,
    cluster: str = "off",
    cluster_veto: Optional[bool] = None,
    db_shards: int = 1,
    shards_per_device: int = 1,
    db_devices: Optional[int] = None,
    residency: str = "hbm",
    segment_rows: Optional[int] = None,
    hbm_budget_bytes: Optional[float] = None,
) -> Plan:
    """Derive every kernel parameter analytically (Eq. 4–10, 13–14).

    ``device`` names a hardware profile (default: :func:`detect_device`).
    ``block_m`` / ``max_block_n`` may only pin the CUDA kernels' fixed
    tiles; ``query_block`` pins the plain paths' block.  ``storage`` and
    ``rescore`` (default: on for a quantized tier) set the over-fetched
    ``k_scan`` (``quant.scan_k``) the bins are planned for and add the
    exact rescore's cost.  ``cluster="auto"`` evaluates the pruned scan
    (:func:`plan_clusters`); ``"off"`` (the default, as in the reference)
    never does.  On the ``"h100"`` profile a plan the crossover enables
    is dropped where the card's price of the pruned scan is at least the
    dense scan's at this batch; ``cluster_veto`` pins that decision (an
    index's, made at build).  ``Plan.cluster_price`` holds the two times
    either way.

    ``residency="host"`` plans the cold tier's segment waves
    (:func:`plan_segments` against ``hbm_budget_bytes``, default the
    profile's ``hbm_bytes``) and never evaluates pruning; unlike the
    reference, the ``"cuda"`` backend is accepted (its kernels scan each
    wave), and its segments are sized for its rows as the kernels hold
    them (``d_pad`` lanes).

    ``backend="sharded"`` with ``db_shards`` > 1 prices one shard's scan
    over ``ceil(n / db_shards)`` rows, its bins laid against the global
    N, plus the gather of the shards' winners (``ici_bytes``, ``ici_s``):
    as the reference prices it (the plain shard's unfused scan, its L bin
    winners gathered, k_scan with a rescore) on every profile but
    ``"h100"``, where each shard runs the port's CUDA scan and sends its
    top-``k_scan``.  ``shards_per_device`` (default 1) and ``db_devices``
    (default ``ceil(db_shards / shards_per_device)``) say how the shards
    lie on the devices; the ``"h100"`` profile prices the busiest
    device's shards one after another (``backends.sharded_search`` loops
    over a device's shards) and the gather as one ``(m, k_scan)`` block
    of winners from each of the ``db_devices`` (where the reference
    counts one a shard; none on one device).  The other profiles ignore
    both and price the reference's plan.

    >>> v = plan_search(n=1_000_000, d=128, k=10, metric="l2",
    ...                 backend="cuda", device="h100", cluster="auto")
    >>> v.cluster.enabled, v.m, v.query_block, v.cluster_veto is not None
    (False, 0, 16, True)

    >>> plan_search(n=64, d=7, k=4, device="cpu").d_pad
    128
    >>> p8 = plan_search(n=1 << 20, d=128, k=10, m=16, backend="cuda",
    ...                  device="h100", storage="int8")
    >>> p8.k_scan, p8.bottleneck
    (20, 'memory')
    """
    if n <= 0 or d <= 0:
        raise ValueError(f"need positive n, d; got n={n}, d={d}")
    if k > n:
        raise ValueError(f"k={k} exceeds database size n={n}")
    if backend not in ("torch", "cuda", "sharded"):
        raise ValueError(
            f'backend must be "torch", "cuda" or "sharded", got {backend!r}')
    if db_shards < 1:
        raise ValueError(f"db_shards must be >= 1, got {db_shards}")
    if not 1 <= shards_per_device <= db_shards:
        raise ValueError(f"shards_per_device must be in [1, db_shards], "
                         f"got {shards_per_device}")
    if db_devices is None:
        db_devices = -(-db_shards // shards_per_device)
    if residency == "host" and backend == "sharded":
        raise ValueError('residency="host" cannot be sharded over a mesh')
    check_tiles(block_m, max_block_n)
    device = detect_device(device)
    hw = HARDWARE[device]
    dtype_name = str(dtype) if dtype is not None else "float32"
    dbytes = _dtype_bytes(dtype)
    # storage="f32" rows stream at the compute dtype's width; the plain
    # path scores int4 codes held one a byte.
    sbytes = dbytes if storage == "f32" else quant.storage_bytes(storage)
    if storage == "int4" and backend != "cuda":
        sbytes = 1.0
    if rescore and storage == "f32":
        raise ValueError(
            'rescore=True requires a quantized storage tier ("bf16", '
            '"int8" or "int4"); storage="f32" is already exact'
        )
    rescore_on = (storage != "f32") if rescore is None else rescore
    ks = quant.scan_k(storage, k, n=n) if rescore_on else k
    if cluster not in ("auto", "off"):
        raise ValueError(f'cluster must be "auto" or "off", got {cluster!r}')
    if residency not in ("hbm", "host"):
        raise ValueError(
            f'residency must be "hbm" or "host", got {residency!r}'
        )
    # a host index never prunes: the gathered scan needs every row resident
    cplan = (plan_clusters(n=n, k_scan=ks, recall_target=recall_target)
             if cluster == "auto" and residency != "host" else None)
    seg_rows, num_segs, budget = 0, 0, 0.0
    d_pad = round_up(d, 128)
    if residency == "host":
        budget = float(hbm_budget_bytes or hw.hbm_bytes)
        # a "cuda" slot holds the kernels' rows, padded to d_pad lanes
        seg_rows, num_segs = plan_segments(
            n=n, d=d, db_bytes=sbytes * d_pad / d if backend == "cuda"
            else sbytes, hbm_budget_bytes=budget, rescore=rescore_on,
            segment_rows=segment_rows,
        )

    bins = plan_bins(
        n, ks, recall_target,
        reduction_input_size_override=reduction_input_size_override,
    )
    # a host wave scores a (query_block, segment_rows) tile
    qb = query_block or _plan_query_block(
        seg_rows if residency == "host" else n, backend)
    m_eff = m if m else qb
    expected = bins.expected_recall
    extra = (_rescore_cost(m_eff, bins.num_bins, ks, d) if rescore_on
             else KernelCost(flops=0.0, hbm_bytes=0.0, cops=0.0))

    def with_rescore(c: KernelCost) -> KernelCost:
        return KernelCost(flops=c.flops + extra.flops,
                          hbm_bytes=c.hbm_bytes + extra.hbm_bytes,
                          cops=c.cops + extra.cops)

    n_scan, scan_bins = n, bins
    if backend == "sharded" and db_shards > 1:
        # the shards run at once: the wall is one shard's scan
        n_scan = -(-n // db_shards)
        scan_bins = plan_bins(n_scan, min(ks, n_scan), recall_target,
                              reduction_input_size_override=n)
    if backend == "cuda" or (backend == "sharded" and device == "h100"):
        cost = _cuda_cost(m_eff, n_scan, d, scan_bins.bin_size, ks, storage,
                          dbytes)
        if backend == "sharded" and shards_per_device > 1:
            # the busiest device scans its shards one after another
            cost = KernelCost(flops=shards_per_device * cost.flops,
                              hbm_bytes=shards_per_device * cost.hbm_bytes,
                              cops=shards_per_device * cost.cops)
    else:
        cost = _dense_cost(m_eff, n_scan, d, scan_bins.num_bins, dbytes,
                           sbytes)
    price, drop = None, False
    if cplan is not None and cplan.enabled:
        # the pruned gathered program replaces the scan on every backend
        if device == "h100":
            pruned = _card_cluster_cost(
                m_eff, d, bins.num_bins, cplan, dbytes, sbytes,
                d_pad if backend == "cuda" else d)
            price, drop = _cluster_veto(with_rescore(pruned),
                                        with_rescore(cost), hw, cluster_veto)
        else:
            pruned = _cluster_cost(m_eff, d, bins.num_bins, cplan, dbytes,
                                   sbytes)
        if not drop:
            cost = pruned
            expected = cplan.recall_decomposition(ks)["expected_recall"]
        else:
            cplan = dataclasses.replace(cplan, enabled=False)
    cost = with_rescore(cost)
    att = attainable_flops(cost, hw)
    predicted_s = cost.flops / att
    ici_bytes = ici_s = 0.0
    if backend == "sharded" and db_shards > 1 and (
            device != "h100" or db_devices > 1):
        # the one cross-device transfer: each shard's (f32 value, int32
        # global id) winners, 8 bytes each; on "h100" one block a device
        cand = ks if rescore_on or device == "h100" else scan_bins.num_bins
        senders = db_devices if device == "h100" else db_shards
        ici_bytes = 8.0 * m_eff * cand * senders
        ici_s = ici_bytes / hw.ici_bandwidth
        predicted_s = predicted_s + ici_s
    pinned = all(v is not None for v in (block_m, max_block_n, query_block))
    return Plan(
        m=m or 0, n=n, d=d, k=k, metric=metric, dtype=dtype_name,
        recall_target=recall_target, backend=backend, device=device,
        num_bins=bins.num_bins, log2_bin_size=bins.log2_bin_size,
        padded_n=bins.padded_n, expected_recall=expected,
        d_pad=d_pad, block_m=kernels.BLOCK_M, block_n=kernels.BLOCK_N,
        query_block=qb, stream=True,
        flops=cost.flops, hbm_bytes=cost.hbm_bytes, cops=cost.cops,
        i_mem=cost.i_mem, i_cop=cost.i_cop,
        attainable_flops=att, bottleneck=bottleneck(cost, hw),
        predicted_s=predicted_s, predicted_qps=m_eff / predicted_s,
        source="user" if pinned else "model",
        reduction_input_size_override=reduction_input_size_override,
        storage=storage, rescore=rescore_on, k_scan=ks, cluster=cplan,
        cluster_price=price, db_shards=db_shards, ici_bytes=ici_bytes,
        ici_s=ici_s, shards_per_device=shards_per_device,
        db_devices=db_devices, residency=residency,
        segment_rows=seg_rows, num_segments=num_segs, hbm_budget_bytes=budget,
    )


# --- measured refinement -----------------------------------------------------


def time_search(index, queries, *, repeats: int = 3, passes: int = 2
                ) -> float:
    """Seconds per ``index.search(queries)``, the first call excluded.

    One warm-up search (it builds the kernels on first use), then the
    best of ``passes`` means over ``repeats`` searches: timed with CUDA
    events on a CUDA device (the card's time, searches queued back to
    back), with ``time.perf_counter`` on the CPU.
    """
    cuda = index.device.type == "cuda"
    index.search(queries)
    if cuda:
        torch.cuda.synchronize(index.device)
    best = float("inf")
    for _ in range(passes):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(repeats):
                index.search(queries)
            end.record()
            end.synchronize()
            wall = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(repeats):
                index.search(queries)
            wall = time.perf_counter() - t0
        best = min(best, wall / repeats)
    return best


def _with_measured_tiles(plan: Plan, bm: int, bn: int, qb: int) -> Plan:
    """The plan re-derived for the measured tiles, so its prediction
    describes the configuration it carries."""
    refreshed = plan_search(
        n=plan.n, d=plan.d, k=plan.k, m=plan.m or None, metric=plan.metric,
        recall_target=plan.recall_target, dtype=plan.dtype,
        backend=plan.backend, device=plan.device,
        reduction_input_size_override=plan.reduction_input_size_override,
        block_m=bm, max_block_n=bn, query_block=qb,
        storage=plan.storage, rescore=plan.rescore,
        cluster="auto" if plan.cluster is not None else "off",
        cluster_veto=plan.cluster_veto is not None,
        db_shards=plan.db_shards, shards_per_device=plan.shards_per_device,
        db_devices=plan.db_devices, residency=plan.residency,
        segment_rows=plan.segment_rows or None,
        hbm_budget_bytes=plan.hbm_budget_bytes or None,
    )
    return dataclasses.replace(refreshed, source="measure")


def _card_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


class PlanCache:
    """Persistent store of measured plan refinements.

    Keys are the card's name and the workload signature (profile,
    backend, metric, compute dtype, shapes, recall target, tier, an
    enabled cluster plan, pins); values
    are the winning tiles and the measured seconds.  Backed by a JSON
    file when ``path`` is given or ``REPRO_TORCH_PLAN_CACHE`` is set, in
    memory otherwise.  A corrupt or missing file reads as empty.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get(_CACHE_ENV)
        self._entries: Dict[str, dict] = {}
        if self.path and os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self._entries = json.load(f)
            except (OSError, ValueError):
                self._entries = {}

    @staticmethod
    def key(plan: Plan, spec: Optional[SearchSpec] = None,
            card: str = "cpu") -> str:
        base = (
            f"{card}/{plan.device}/{plan.backend}/{plan.metric}/{plan.dtype}"
            f"/m{plan.m}/n{plan.n}/d{plan.d}/k{plan.k}/r{plan.recall_target}"
        )
        if plan.storage != "f32":
            base += f"/st-{plan.storage}" + ("" if plan.rescore else "-raw")
        if plan.cluster is not None and plan.cluster.enabled:
            # the pruned gathered program times nothing like the full scan
            base += "/cl"
        if plan.db_shards > 1:
            base += f"/sh{plan.db_shards}"
            if plan.shards_per_device > 1:
                base += f"x{plan.shards_per_device}"
        if plan.residency != "hbm":
            # nor do the segment waves, which stream the rows each search
            base += f"/host{plan.segment_rows}"
        if spec is not None and not (
            spec.block_m is None
            and spec.max_block_n is None
            and spec.query_block is None
        ):
            # A sweep under pins is not served to unpinned builds.
            base += f"/pin{spec.block_m}-{spec.max_block_n}-{spec.query_block}"
        return base

    def get(self, plan: Plan, spec: Optional[SearchSpec] = None,
            card: str = "cpu") -> Optional[dict]:
        return self._entries.get(self.key(plan, spec, card))

    def put(self, plan: Plan, entry: dict,
            spec: Optional[SearchSpec] = None, card: str = "cpu") -> None:
        self._entries[self.key(plan, spec, card)] = entry
        if self.path:
            with open(self.path, "w") as f:
                json.dump(self._entries, f, indent=1, sort_keys=True)

    def __len__(self) -> int:
        return len(self._entries)


def _tile_candidates(plan: Plan, spec: Optional[SearchSpec] = None) -> list:
    """The sweep around the model's pick: ``query_block`` halved, kept and
    doubled (clamped to [8, 8192], multiples of 8), unless the spec pins
    it.  The CUDA tiles are fixed, so they never vary (the reference's
    rule for its paths that ignore the Pallas tiles)."""

    def clamp_qb(v):
        return max(8, min(8192, round_up(v, 8)))

    q_factors = (1, 0.5, 2) if (
        spec is None or spec.query_block is None) else (1,)
    cands = []
    for fq in q_factors:
        c = (plan.block_m, plan.block_n, clamp_qb(int(plan.query_block * fq)))
        if c not in cands:
            cands.append(c)
    return cands


def tune_plan(
    database: torch.Tensor,
    plan: Plan,
    *,
    spec: Optional[SearchSpec] = None,
    cache: Optional[PlanCache] = None,
    repeats: int = 3,
    device=None,
) -> Plan:
    """Refine a model plan with a short timed sweep (``plan="measure"``).

    Builds a throwaway index per candidate of :func:`_tile_candidates`
    that searches on ``device`` (default: ``database``'s; a host index's
    rows stay in host memory, so its build passes the device its
    searches run on), times a batch of ``plan.m`` queries (one
    ``query_block`` if 0, at most two) with :func:`time_search`, and
    returns the plan re-derived for the fastest (``source="measure"``).
    The result is kept in ``cache`` under the card's name, so a later
    build of the same workload on that card runs no timing.  ``spec`` is
    the workload's own spec: candidates replace only its tile fields (a
    host plan's candidates stream its segments).
    """
    from repro_torch.search.index import Index  # index imports plan

    if cache is None:  # NOT ``or``: an empty PlanCache is falsy
        cache = PlanCache()
    device = torch.device(device) if device is not None else database.device
    card = _card_name(device)
    base_spec = spec if spec is not None else SearchSpec(
        metric=plan.metric, k=plan.k, recall_target=plan.recall_target,
        backend=plan.backend, storage=plan.storage, rescore=plan.rescore,
        residency=plan.residency,
    )
    hit = cache.get(plan, spec, card)
    if hit is not None:
        return _with_measured_tiles(
            plan, hit["block_m"], hit["block_n"], hit["query_block"]
        )

    m_eff = plan.m or plan.query_block
    g = torch.Generator(device=device).manual_seed(0)
    queries = torch.randn((min(m_eff, 2 * plan.query_block), plan.d),
                          generator=g, device=device)
    # Every candidate is a valid build (only query_block varies, within
    # its clamp), so a failing one fails the sweep (the reference skips
    # candidates its backend rejects).
    best, best_wall = None, float("inf")
    for bm, bn, qb in _tile_candidates(plan, spec):
        cand = dataclasses.replace(
            base_spec, block_m=bm, max_block_n=bn, query_block=qb,
            segment_rows=base_spec.segment_rows or (plan.segment_rows or None),
        )
        # Every tile pinned: the candidate's own plan is no sweep.
        index = Index.build(database, spec=cand, plan="model",
                            device=device, profile=plan.device)
        wall = time_search(index, queries, repeats=repeats, passes=1)
        if wall < best_wall:
            best, best_wall = (bm, bn, qb), wall
    cache.put(plan, {
        "block_m": best[0], "block_n": best[1], "query_block": best[2],
        "wall_s": best_wall, "source": "measure",
    }, spec, card)
    return _with_measured_tiles(plan, *best)


# --- the FLOP cross-check (the reference's HLO self-audit) -------------------


def split_passes(plan: Plan) -> int:
    """The tensor-core passes the plan charges a CUDA scan (the exact
    bf16 split, :data:`_SPLIT_PASSES`; one with bf16 queries), 1 for a
    plain path."""
    cuda = plan.backend == "cuda" or (plan.backend == "sharded"
                                      and plan.device == "h100")
    if not cuda:
        return 1
    dbytes = _dtype_bytes(plan.dtype)
    if dbytes == 2:
        return 1
    return _SPLIT_PASSES["f32" if plan.storage == "f32" else plan.storage]


def hlo_check(plan: Plan, cost) -> dict:
    """The plan's analytic cost beside the ops a search runs.

    ``cost`` is ``repro_torch.analysis.op_cost.search_cost`` of the index
    at the plan's batch: the dot FLOPs, byte and COP counts of its plain
    search path, counted without running it.  The reference's keys
    (``flops_ratio``: the counted dot FLOPs over the model's), and
    ``split_passes``: the model charges the CUDA scan the passes of its
    exact bf16 split where the kernel's plain version does one product,
    so the ratio counts the scan's FLOPs that many times (the plan's
    scan divided by its passes, against the plain version).  Bytes and
    COPs are op-granularity estimates on both sides, so only reported.
    """
    passes = split_passes(plan)
    counted = cost.dot_flops + (passes - 1) * cost.kernel_dot_flops
    return {
        "model_flops": plan.flops,
        "hlo_dot_flops": cost.dot_flops,
        "flops_ratio": counted / max(plan.flops, 1e-30),
        "split_passes": passes,
        "model_hbm_bytes": plan.hbm_bytes,
        "hlo_hbm_bytes": cost.hbm_bytes,
        "hlo_hbm_bytes_bounds": (cost.hbm_bytes_lo, cost.hbm_bytes_hi),
        "model_cops": plan.cops,
        "hlo_cop_count": cost.cop_count,
    }
