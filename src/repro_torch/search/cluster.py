"""Cluster-pruned scan front-end: a tuning-free k-means coarse quantizer.

Port of ``src/repro/search/cluster.py`` (its whole ``__all__``).  The
packed database keeps its row order; a clustered index adds a
:class:`ClusterState` of side tables:

  * ``centroids``      (C, d) metric-prepared k-means centroids, f32;
  * ``centroid_bias``  (C,)   their fused metric bias, so queries rank
    centroids with the same biased-MIPS scoring the row scan uses;
  * ``cluster_rows``   (C, R) user row ids per cluster, ``-1`` = empty;
  * ``spill_rows``     (B,)   an always-scanned overflow block.

The pruned scan (``search.backends.cluster_search_quant``) scores the C
centroids, gathers the rows of the top-``probes`` clusters plus the spill
block (S = probes·R + B slots, empty slots masked) and reduces those S
candidates only.  Every parameter is derived from (N, k, recall_target)
by the closed forms below (the reference's derivation: a miss budget of
half the allowed loss, probes from a geometric-decay miss model with a
C/32 floor, C = 2^ceil(log2 sqrt N), 25 % slot headroom, a spill block of
max(64, N/64)), so E[recall] is a product of a collision term and a miss
term.  The planner's crossover (``search.plan.plan_clusters``) prices
FLOPs, not geometry: the build measures the tables' miss rate on sampled
rows (:func:`sampled_miss_rate`) and drops them past
:func:`miss_check_threshold`, which keeps structureless data on the dense
scan.

Nothing here draws random numbers: k-means starts from a strided pick
of rows and runs ``KMEANS_ITERS`` Lloyd iterations, and the miss check
samples with a stride, as in the reference, so the port's tables can be
held to the reference's directly.  Order-sensitive steps keep the
reference's tie rule (``argmax`` and top-k take the lowest index first:
:func:`repro_torch.core.rescoring.stable_topk`).  The greedy slot
assignment is the reference's host loop, in its order.  K-means sums
each cluster's rows in row order (a stable sort by cluster, then a
segment sum), so a build gives the same centroids run after run, on the
CPU and on the card; the two devices differ only where their matmuls
round the assignment logits differently.

Nothing here imports the rest of ``repro_torch.search``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.binning import plan_bins, round_up
from repro_torch.core.rescoring import stable_topk

__all__ = [
    "ClusterPlan",
    "ClusterState",
    "KMEANS_ITERS",
    "assign_rows",
    "build_tables",
    "kmeans",
    "miss_budget_for",
    "miss_check_threshold",
    "num_clusters_for",
    "probes_for",
    "query_miss_rate",
    "restore_tables",
    "sampled_miss_rate",
    "snapshot_tables",
    "spill_capacity_for",
]

KMEANS_ITERS = 8
_ASSIGN_CANDIDATES = 8
EMPTY_SLOT = -1
_BALANCE_SLACK = 1.25
_SPILL_REPLAN_FRACTION = 0.5
_MISS_CHECK_SAMPLES = 256
_MISS_CHECK_SLACK = 2.0
_MISS_CHECK_FLOOR = 0.08

# Rows scored against the centroids at a time (k-means assignment and
# the nearest-centroid candidates): bounds the (rows, C) f32 logits.
_ROW_CHUNK_BYTES = 1 << 30


def num_clusters_for(n: int) -> int:
    """Centroid count: ``2^ceil(log2(sqrt(n)))``.

    >>> num_clusters_for(8192), num_clusters_for(16384), num_clusters_for(10**6)
    (128, 128, 1024)
    """
    if n <= 1:
        return 1
    return 1 << max(0, math.ceil(math.log2(math.sqrt(n))))


def miss_budget_for(recall_target: float) -> float:
    """Cluster-miss probability budget: half the allowed recall loss."""
    if not 0.0 < recall_target < 1.0:
        raise ValueError(f"recall_target must be in (0, 1), got {recall_target}")
    return (1.0 - recall_target) / 2.0


def probes_for(recall_target: float, num_clusters: int = 128) -> int:
    """Probe count from the geometric-decay miss model (``p_miss <=
    2^-probes`` against the budget), floored at ``C/32`` probes.

    >>> probes_for(0.90), probes_for(0.95), probes_for(0.99)
    (5, 6, 8)
    >>> probes_for(0.95, num_clusters=1024)
    32
    """
    budget = miss_budget_for(recall_target)
    decay = max(1, math.ceil(math.log2(1.0 / budget)))
    floor = -(-num_clusters // 32)
    return min(max(1, num_clusters - 1), max(decay, floor))


def spill_capacity_for(n: int) -> int:
    """Always-scanned overflow slots: ``roundup(max(64, n/64), 8)``."""
    return round_up(max(64, n // 64), 8)


def rows_per_cluster_for(n: int, num_clusters: int) -> int:
    """Slots a cluster, with 25 % headroom over the ideal fill, a
    multiple of 8.

    >>> rows_per_cluster_for(1_000_000, 1024)
    1224
    """
    ideal = math.ceil(n / max(1, num_clusters))
    return round_up(max(1, math.ceil(ideal * _BALANCE_SLACK)), 8)


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """Derived cluster-pruning parameters for one row space (built by
    ``search.plan.plan_clusters``); ``enabled=False`` records that the
    planner evaluated pruning and rejected it."""

    n: int
    num_clusters: int
    rows_per_cluster: int
    probes: int
    spill_capacity: int
    miss_budget: float
    target_scan: float
    predicted_speedup: float
    enabled: bool

    @property
    def scan_rows(self) -> int:
        """Candidate slots per query: probed cluster slots + spill block."""
        return self.probes * self.rows_per_cluster + self.spill_capacity

    @property
    def scanned_fraction(self) -> float:
        """Predicted fraction of the row space scanned per query."""
        return min(1.0, self.scan_rows / max(1, self.n))

    def recall_decomposition(self, k_scan: int) -> dict:
        """The product guarantee: the collision term (Eq. 13 over the S
        scanned slots at ``target_scan``; 1 for bins of one slot, where the
        reduction is exact) times the miss term."""
        bins = plan_bins(
            self.scan_rows, min(k_scan, self.scan_rows), self.target_scan
        )
        collision = 1.0 if bins.log2_bin_size == 0 else bins.expected_recall
        miss = 1.0 - self.miss_budget
        return {
            "collision_term": collision,
            "miss_term": miss,
            "expected_recall": collision * miss,
        }


@dataclasses.dataclass
class ClusterState:
    """Side tables (tensors on the index's device, search operands like the
    bias row) and their fill counts on the host.  The tables are patched
    in place by :func:`assign_rows`."""

    plan: ClusterPlan
    centroids: torch.Tensor      # (C, d) f32
    centroid_bias: torch.Tensor  # (C,) f32
    cluster_rows: torch.Tensor   # (C, R) int32 user row ids, EMPTY_SLOT pad
    spill_rows: torch.Tensor     # (B,) int32 user row ids, EMPTY_SLOT pad
    counts: np.ndarray           # host (C,) slots used per cluster
    spill_count: int = 0
    spill_baseline: int = 0      # spill level right after (re)build
    # served-query miss monitor (``query_miss_rate`` counts)
    served_miss_checked: int = 0
    served_miss_missed: int = 0

    def operands(self) -> Tuple[torch.Tensor, ...]:
        """The tensors the pruned scan consumes, in its argument order."""
        return (self.centroids, self.centroid_bias, self.cluster_rows,
                self.spill_rows)

    @property
    def served_miss_rate(self) -> Optional[float]:
        """Miss rate of the served queries sampled so far (None before
        any)."""
        if self.served_miss_checked == 0:
            return None
        return self.served_miss_missed / self.served_miss_checked

    def served_miss_report(self) -> dict:
        """The served-query miss block of ``Index.explain()``."""
        rate = self.served_miss_rate
        threshold = miss_check_threshold(self.plan.miss_budget)
        return {
            "sampled_pairs": self.served_miss_checked,
            "miss_rate": rate,
            "warn_threshold": threshold,
            "warning": rate is not None and rate > threshold,
        }

    @property
    def needs_recluster(self) -> bool:
        """The lazy-recluster trigger: the spill block has grown by more
        than half its capacity since the tables were built."""
        grown = self.spill_count - self.spill_baseline
        return grown > int(self.plan.spill_capacity * _SPILL_REPLAN_FRACTION)


def _row_chunks(n: int, width: int):
    """Row ranges whose (rows, width) f32 logits fit ``_ROW_CHUNK_BYTES``."""
    step = max(1, _ROW_CHUNK_BYTES // (4 * max(1, width)))
    for s in range(0, n, step):
        yield s, min(n, s + step)


def _segment_sums(rows: torch.Tensor, assign: torch.Tensor,
                  num_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums, counts) of ``rows`` by segment id ``assign``, each segment's
    rows added in row order from zero: the sequential sums of the
    reference's ``segment_sum`` on the CPU, with no atomics on the card
    (``index_add_`` has them there), so every run gives the same bits."""
    order = torch.argsort(assign, stable=True)
    lengths = torch.bincount(assign, minlength=num_segments)
    sums = torch.segment_reduce(rows[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)
    return sums, lengths.to(torch.float32)


def kmeans(rows: torch.Tensor, num_clusters: int,
           iters: int = KMEANS_ITERS) -> torch.Tensor:
    """Deterministic Lloyd k-means over metric-prepared rows.

    Strided init over the row order, relaxed-L2 assignment (``argmax <x,
    mu> - ||mu||^2/2``, the first index winning ties), mean update by
    segment sums (:func:`_segment_sums`) with empty clusters keeping their
    old centroid.

    >>> kmeans(torch.eye(8, 4), 2).shape
    torch.Size([2, 4])
    """
    rows = rows.to(torch.float32)
    n = rows.shape[0]
    if num_clusters > n:
        raise ValueError(f"num_clusters={num_clusters} exceeds rows n={n}")
    cents = rows[(torch.arange(num_clusters, device=rows.device) * n)
                 // num_clusters]
    assign = torch.empty((n,), dtype=torch.int64, device=rows.device)
    for _ in range(iters):
        half = 0.5 * torch.sum(cents * cents, -1)
        for s, e in _row_chunks(n, num_clusters):
            logits = rows[s:e] @ cents.T - half[None, :]
            assign[s:e] = torch.argmax(logits, -1)
        sums, cnt = _segment_sums(rows, assign, num_clusters)
        cents = torch.where(
            cnt[:, None] > 0, sums / torch.clamp(cnt, min=1.0)[:, None], cents
        )
    return cents


def _nearest_candidates(rows: torch.Tensor, centroids: torch.Tensor,
                        centroid_bias: torch.Tensor, width: int) -> np.ndarray:
    """Host (r, width) centroid ids per row, best first (lowest id among
    ties), by the biased-MIPS affinity the search probes use."""
    width = min(width, centroids.shape[0])
    rows = rows.to(torch.float32)
    out = []
    for s, e in _row_chunks(rows.shape[0], centroids.shape[0]):
        aff = rows[s:e] @ centroids.T + centroid_bias[None, :]
        out.append(stable_topk(aff, width)[1].cpu())
    if not out:
        return np.zeros((0, width), np.int64)
    return torch.cat(out).numpy()


def _live_ids(live, capacity: int) -> np.ndarray:
    if live is None:
        return np.arange(capacity)
    if isinstance(live, torch.Tensor):
        live = live.cpu().numpy()
    return np.flatnonzero(np.asarray(live))


def build_tables(
    rows: torch.Tensor,
    live,
    plan: ClusterPlan,
    prepare: Callable[[torch.Tensor], Tuple[torch.Tensor, Optional[torch.Tensor]]],
    *,
    timings: Optional[dict] = None,
) -> ClusterState:
    """The side tables for ``rows`` (build and lazy recluster).

    ``rows`` are the metric-prepared full-precision rows of the whole
    capacity, ``live`` a bool mask (None: all live; dead rows get no
    slot), ``prepare`` the metric's ``prepare_database``, re-run on the
    raw centroids.  The capacity-constrained greedy assignment is the
    reference's host loop: each live row, in row order, to its best
    centroid with a free slot among ``_ASSIGN_CANDIDATES``, else the spill
    block, else (spill full) the emptiest cluster.  ``timings``, when
    given, receives the seconds of ``kmeans`` and of the host loop.
    """
    live_idx = _live_ids(live, rows.shape[0])
    if live_idx.size < plan.num_clusters:
        raise ValueError(
            f"cannot build {plan.num_clusters} clusters from "
            f"{live_idx.size} live rows"
        )
    t0 = time.perf_counter()
    live_rows = rows[torch.as_tensor(live_idx, device=rows.device)]
    raw_cents = kmeans(live_rows, plan.num_clusters)
    cents, cent_bias = prepare(raw_cents)
    cents = cents.to(torch.float32)
    bias = (torch.zeros((plan.num_clusters,), dtype=torch.float32,
                        device=rows.device)
            if cent_bias is None else cent_bias.to(torch.float32))
    cand = _nearest_candidates(live_rows, cents, bias, _ASSIGN_CANDIDATES)
    t1 = time.perf_counter()

    # The host loop, on Python lists (numpy scalars cost more per step).
    R, B = plan.rows_per_cluster, plan.spill_capacity
    table = np.full((plan.num_clusters, R), EMPTY_SLOT, np.int32)
    spill = np.full((B,), EMPTY_SLOT, np.int32)
    counts = [0] * plan.num_clusters
    spill_count = 0
    slot_c, slot_j, slot_id = [], [], []
    for rid, cs in zip(live_idx.tolist(), cand.tolist()):
        placed = False
        for c in cs:
            if counts[c] < R:
                slot_c.append(c)
                slot_j.append(counts[c])
                slot_id.append(rid)
                counts[c] += 1
                placed = True
                break
        if placed:
            continue
        if spill_count < B:
            spill[spill_count] = rid
            spill_count += 1
        else:
            c = int(np.argmin(counts))
            slot_c.append(c)
            slot_j.append(counts[c])
            slot_id.append(rid)
            counts[c] += 1
    table[slot_c, slot_j] = slot_id
    if timings is not None:
        timings["kmeans_s"] = t1 - t0
        timings["assign_s"] = time.perf_counter() - t1
    return ClusterState(
        plan=plan,
        centroids=cents,
        centroid_bias=bias,
        cluster_rows=torch.as_tensor(table, device=rows.device),
        spill_rows=torch.as_tensor(spill, device=rows.device),
        counts=np.asarray(counts, np.int64),
        spill_count=spill_count,
        spill_baseline=spill_count,
    )


def miss_check_threshold(miss_budget: float) -> float:
    """Acceptance threshold of the build-time miss check,
    ``max(2 x budget, 0.08)``.

    >>> miss_check_threshold(0.05), miss_check_threshold(0.005)
    (0.1, 0.08)
    """
    return max(_MISS_CHECK_SLACK * miss_budget, _MISS_CHECK_FLOOR)


def sampled_miss_rate(state: ClusterState, rows: torch.Tensor,
                      bias_row: torch.Tensor, live, k: int) -> float:
    """Measured cluster-miss rate of built tables: up to 256 live rows,
    picked with a stride, as query proxies; of each proxy's true top-``k``
    (a dense scored pass with the fused bias), the share whose home
    cluster is not among its top-``probes`` centroids (spill rows always
    hit)."""
    rows = rows.to(torch.float32)
    live_idx = _live_ids(live, rows.shape[0])
    m = min(_MISS_CHECK_SAMPLES, live_idx.size)
    sample = live_idx[(np.arange(m) * live_idx.size) // m]
    q = rows[torch.as_tensor(sample, device=rows.device)]
    k_eff = max(1, min(k, live_idx.size))
    missed, checked = _miss_counts(state, q, rows, bias_row, k_eff)
    return missed / checked


def query_miss_rate(state: ClusterState, queries: torch.Tensor,
                    rows: torch.Tensor, bias_row: torch.Tensor,
                    k: int) -> Tuple[int, int]:
    """``(missed, checked)`` neighbour pairs of real queries, measured as
    :func:`sampled_miss_rate` measures its proxies; ``rows``/``bias_row``
    are the exact prepared rows and fused bias
    (``PackedState.exact_rows_bias()``)."""
    q = queries.to(torch.float32)
    rows = rows.to(torch.float32)
    k_eff = max(1, min(k, rows.shape[0]))
    return _miss_counts(state, q, rows, bias_row, k_eff)


def _miss_counts(state: ClusterState, q: torch.Tensor, rows: torch.Tensor,
                 bias_row: torch.Tensor, k_eff: int) -> Tuple[int, int]:
    """Of the true top-``k_eff`` neighbour pairs of ``q``, how many live in
    clusters the probe schedule would not visit (host ints)."""
    plan = state.plan
    capacity = rows.shape[0]
    scores = q @ rows.T + bias_row.to(torch.float32).reshape(-1)[None, :]
    true_ids = stable_topk(scores, k_eff)[1].cpu().numpy()
    caff = q @ state.centroids.T + state.centroid_bias[None, :]
    probed = stable_topk(caff, plan.probes)[1].cpu().numpy()

    member = np.full((capacity,), -1, np.int64)
    tbl = state.cluster_rows.cpu().numpy()
    filled = tbl >= 0
    member[tbl[filled]] = np.nonzero(filled)[0]
    in_spill = np.zeros((capacity,), bool)
    sp = state.spill_rows.cpu().numpy()
    in_spill[sp[sp >= 0]] = True

    hit = in_spill[true_ids]
    hit |= (member[true_ids][:, :, None] == probed[:, None, :]).any(-1)
    return int(hit.size - hit.sum()), int(hit.size)


def snapshot_tables(state: ClusterState) -> Tuple[dict, dict]:
    """``(arrays, meta)`` of a ClusterState, under the reference's names."""
    arrays = {
        "cluster/centroids": state.centroids,
        "cluster/centroid_bias": state.centroid_bias,
        "cluster/cluster_rows": state.cluster_rows,
        "cluster/spill_rows": state.spill_rows,
        "cluster/counts": np.asarray(state.counts),
    }
    meta = {
        "plan": dataclasses.asdict(state.plan),
        "spill_count": int(state.spill_count),
        "spill_baseline": int(state.spill_baseline),
        "served_miss_checked": int(state.served_miss_checked),
        "served_miss_missed": int(state.served_miss_missed),
    }
    return arrays, meta


def _as_tensor(a, device, dtype) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))  # a writable copy
    return a.to(device=device, dtype=dtype)


def restore_tables(arrays: dict, meta: dict, device="cuda") -> ClusterState:
    """Inverse of :func:`snapshot_tables` (the reference's or the port's,
    numpy arrays or tensors), on ``device`` (a CUDA device unless the
    caller passes ``device="cpu"``); unknown plan fields raise."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "restore_tables puts the tables on a CUDA device by default and "
            "none is available; pass device='cpu' for the plain PyTorch path"
        )
    plan_dict = dict(meta["plan"])
    known = {f.name for f in dataclasses.fields(ClusterPlan)}
    unknown = sorted(set(plan_dict) - known)
    if unknown:
        raise ValueError(
            f"snapshot cluster plan carries unknown fields {unknown} — "
            "written by a newer version? Rebuild the index or upgrade."
        )
    return ClusterState(
        plan=ClusterPlan(**plan_dict),
        centroids=_as_tensor(arrays["cluster/centroids"], device, torch.float32),
        centroid_bias=_as_tensor(arrays["cluster/centroid_bias"], device,
                                 torch.float32),
        cluster_rows=_as_tensor(arrays["cluster/cluster_rows"], device,
                                torch.int32),
        spill_rows=_as_tensor(arrays["cluster/spill_rows"], device, torch.int32),
        counts=np.asarray(arrays["cluster/counts"]).astype(np.int64),
        spill_count=int(meta["spill_count"]),
        spill_baseline=int(meta["spill_baseline"]),
        served_miss_checked=int(meta.get("served_miss_checked", 0)),
        served_miss_missed=int(meta.get("served_miss_missed", 0)),
    )


def assign_rows(state: ClusterState, rows: torch.Tensor, start: int) -> None:
    """Slot appended rows (user ids ``start..start+r``) against the
    existing centroids: nearest centroid with a free slot, else the spill
    block, else (spill full) the emptiest cluster.  Patches the tables in
    place; ``state.needs_recluster`` tells ``Index.add`` when to rebuild
    them."""
    rows = torch.atleast_2d(rows)
    cand = _nearest_candidates(rows, state.centroids, state.centroid_bias,
                               _ASSIGN_CANDIDATES)
    R, B = state.plan.rows_per_cluster, state.plan.spill_capacity
    tbl_c, tbl_j, tbl_id = [], [], []
    sp_j, sp_id = [], []
    for off, cs in enumerate(cand.tolist()):
        rid = start + off
        placed = False
        for c in cs:
            if state.counts[c] < R:
                tbl_c.append(c)
                tbl_j.append(int(state.counts[c]))
                tbl_id.append(rid)
                state.counts[c] += 1
                placed = True
                break
        if placed:
            continue
        if state.spill_count < B:
            sp_j.append(state.spill_count)
            sp_id.append(rid)
            state.spill_count += 1
        else:
            c = int(np.argmin(state.counts))
            tbl_c.append(c)
            tbl_j.append(int(state.counts[c]))
            tbl_id.append(rid)
            state.counts[c] += 1
    dev = state.cluster_rows.device
    if tbl_id:
        state.cluster_rows[torch.as_tensor(tbl_c, device=dev),
                           torch.as_tensor(tbl_j, device=dev)] = torch.as_tensor(
            tbl_id, dtype=torch.int32, device=dev)
    if sp_id:
        state.spill_rows[torch.as_tensor(sp_j, device=dev)] = torch.as_tensor(
            sp_id, dtype=torch.int32, device=dev)
