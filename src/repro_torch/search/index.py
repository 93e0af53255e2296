"""Index: the index-free front door of the search API.

Port of ``src/repro/search/index.py`` (every storage tier, both
compute dtypes, cluster pruning, one device).  ``Index.build`` does the
only precompute the algorithm needs — the cast to ``spec.dtype``, metric
preparation, quantization for a ``storage`` tier other than f32, packing
into the backend's layout (``repro_torch.search.packed``) and, where the
planner enables it (``cluster="auto"``) and the build's miss check
accepts them, the cluster tables — and ``add``/``delete`` patch that
state in place: only appended rows are prepared (and slotted into the
cluster tables), deletes rewrite bias entries, and capacity grows in
``capacity_block`` steps with a bin re-plan.  An ``add`` that spills past
the planner's threshold rebuilds the tables (the lazy recluster).

A quantized tier searches in two passes: the scan keeps ``k_scan``
over-fetched candidates (``packed.scan_k_for``), an exact rescore picks
the top-k.  ``k_scan`` is capped by the live row count, as the
reference caps it when it builds a search program; the port binds it
when the packed state changes (build, growth, and an ``add`` while the
bound value is below the uncapped over-fetch), so a search never waits
on the device to count live rows.

``device=`` is the torch device the index lives on (the reference's
``device=`` names a hardware profile; here that is ``profile=``).  The
default is ``"cuda"``: without a CUDA device ``build`` raises unless the
caller asks for ``device="cpu"``.

The kernel plan (``repro_torch.search.plan``) comes from the
performance model (``plan="model"``), from a short timed sweep
(``plan="measure"``) or from a ``Plan`` the caller passes;
``kernel_plan`` holds it and ``explain()`` reports it.  Where the
``"h100"`` profile vetoes the cluster plan, the build runs no k-means,
and every later re-plan (growth, ``explain(m=...)``, a server's
prediction per bucket) keeps that decision.

On a CUDA device the ``"cuda"`` backend searches any number of queries
with a fixed number of kernel launches.  The plain paths — the
``"torch"`` backend anywhere, and the ``"cuda"`` backend's plain kernel
versions on the CPU — stream queries in ``spec.query_block`` blocks to
bound their (query_block, N) score tile.  On a CUDA device
``search_graph(m)`` captures one search of an (m, D) block as a CUDA
graph (``backends.GraphCache``); ``SearchServer`` replays those, and
``search`` itself stays eager.

``save``/``restore`` write and read crash-safe snapshots in the
reference's format (``repro_torch.checkpoint``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.binning import BinPlan, plan_bins, round_up
from repro_torch.search import backends, faults, packed as packedlib, quant
from repro_torch.search import plan as planlib
from repro_torch.search import telemetry
from repro_torch.search.metrics import Metric, get_metric
from repro_torch.search.spec import SearchSpec

__all__ = ["Index", "SNAPSHOT_FORMAT", "SNAPSHOT_VERSION", "SearchResult"]

# The reference's snapshot stamp: either package restores the other's.
SNAPSHOT_FORMAT = "repro.search.index"
SNAPSHOT_VERSION = 1

# Backend names in a snapshot's spec: the reference's, both ways.
_REFERENCE_BACKEND = {"auto": "auto", "torch": "xla", "cuda": "pallas"}
_PORT_BACKEND = {"auto": "auto", "xla": "torch", "pallas": "cuda"}

class SearchResult(NamedTuple):
    """(values, indices), both (M, k); value conventions per the metric
    contract in ``repro_torch.search.metrics``."""

    values: torch.Tensor
    indices: torch.Tensor


def _cluster_pin(plan: planlib.Plan) -> Optional[bool]:
    """An index's cluster decision read off its kernel plan: True where
    the ``"h100"`` model vetoed the crossover's plan, False where the plan
    stands, None where no plan was enabled to price."""
    if plan.cluster_veto is not None:
        return True
    if plan.cluster is not None and plan.cluster.enabled:
        return False
    return None


def _resolve_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Index.build runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return device


class Index:
    """Searchable database under one ``SearchSpec``.

    Build one with ``Index.build(db, metric=..., k=..., ...)``.  ``add`` and
    ``delete`` update in place and return ``self``.
    """

    def __init__(
        self,
        spec: SearchSpec,
        db: torch.Tensor,
        live: torch.Tensor,
        size: int,
        num_live: Union[int, torch.Tensor],
        *,
        capacity_block: int = 1024,
        kernel_plan: planlib.Plan,
    ):
        self.spec = spec
        self._db = db
        self._live = live
        self._size = size          # append high-water mark (<= capacity)
        self._num_live = num_live  # live rows; int, or a lazy device scalar
        self._capacity_block = capacity_block
        self._kernel_plan = kernel_plan
        self._packed: Optional[packedlib.PackedState] = None
        self._k_scan: Optional[int] = None  # bound with the packed state
        # The build's cluster decision, kept by every re-plan (the veto
        # depends on the batch, the tables do not): True vetoed, False
        # kept, None never priced (cluster="off", below the crossover).
        self._cluster_vetoed = _cluster_pin(kernel_plan)
        self._graphs = backends.GraphCache()
        # seconds of the last full pack's cluster steps (k-means, the host
        # assignment loop, the miss check) and the sampled miss rate
        self.pack_timings: dict = {}

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls,
        database,
        *,
        metric: str = "mips",
        k: int = 10,
        recall_target: float = 0.95,
        backend: str = "auto",
        spec: Optional[SearchSpec] = None,
        capacity: Optional[int] = None,
        capacity_block: int = 1024,
        plan: Union[str, planlib.Plan] = "model",
        device=None,
        profile: Optional[str] = None,
        plan_cache: Optional[planlib.PlanCache] = None,
        **spec_kwargs,
    ) -> "Index":
        """Create an index over ``database`` rows (N, D) on ``device``.

        ``spec`` overrides the individual (metric, k, ...) arguments when
        given.  ``capacity`` pre-allocates room for ``add`` beyond N.

        ``plan`` chooses the kernel plan for the spec fields left None:

          * ``"model"`` (default): the performance model
            (``repro_torch.search.plan.plan_search``);
          * ``"measure"``: the model's plan refined by a short timed sweep
            on ``device`` (``plan.tune_plan``), kept in ``plan_cache`` (or
            the ``REPRO_TORCH_PLAN_CACHE`` file);
          * a ``repro_torch.search.plan.Plan``: used as it is.

        ``profile`` names the hardware profile the model prices the plan
        with (``repro_torch.core.roofline.HARDWARE``; default: the one of
        ``device``, ``plan.detect_device``).  The tiles are the CUDA
        kernels' fixed 128 x 128 whatever the plan.

        >>> import torch
        >>> idx = Index.build(torch.eye(32), metric="mips", k=2, device="cpu")
        >>> idx.spec.resolved, idx.plan.num_bins, idx.kernel_plan.source
        (True, 32, 'model')
        """
        if spec is None:
            spec = SearchSpec(
                metric=metric, k=k, recall_target=recall_target,
                backend=backend, **spec_kwargs,
            )
        # fail early on an unknown metric or a metric x storage mismatch
        quant.check_metric_storage(get_metric(spec.metric), spec.storage)
        device = _resolve_device(device)
        database = torch.as_tensor(database, dtype=torch.float32, device=device)
        if database.ndim != 2:
            raise ValueError(
                f"database must be (N, D), got {tuple(database.shape)}"
            )
        n = database.shape[0]
        cap = max(n, capacity or n)
        if cap > n:
            cap = round_up(cap, capacity_block)
            database = F.pad(database, (0, 0, 0, cap - n))

        # The plan covers the capacity's row space, as the packed layout
        # (and its bin plan) does.
        plan_backend = spec.backend
        if plan_backend == "auto":
            plan_backend = backends.default_backend(device)
        if isinstance(plan, planlib.Plan):
            plan_obj = plan
        elif plan in ("model", "measure"):
            plan_obj = planlib.plan_search(
                n=cap, d=database.shape[1], k=spec.k, metric=spec.metric,
                recall_target=spec.recall_target,
                dtype=spec.dtype or "float32", backend=plan_backend,
                device=planlib.detect_device(profile, device=device),
                reduction_input_size_override=
                    spec.reduction_input_size_override,
                block_m=spec.block_m, max_block_n=spec.max_block_n,
                query_block=spec.query_block,
                storage=spec.storage, rescore=spec.rescore_enabled,
                cluster=spec.cluster,
            )
            if plan == "measure" and plan_obj.source != "user":
                plan_obj = planlib.tune_plan(database, plan_obj, spec=spec,
                                             cache=plan_cache)
        else:
            raise ValueError(
                f"plan must be 'model', 'measure' or a Plan, got {plan!r}"
            )
        spec = plan_obj.to_spec(spec)
        live = torch.zeros((cap,), dtype=torch.bool, device=device)
        live[:n] = True
        index = cls(spec, database, live, size=n, num_live=n,
                    capacity_block=capacity_block, kernel_plan=plan_obj)
        index.pack()
        return index

    # -- introspection -------------------------------------------------------

    @property
    def metric(self) -> Metric:
        return get_metric(self.spec.metric)

    @property
    def device(self) -> torch.device:
        return self._db.device

    @property
    def capacity(self) -> int:
        return self._db.shape[0]

    @property
    def dim(self) -> int:
        return self._db.shape[1]

    @property
    def size(self) -> int:
        """Number of live rows (reading it materializes the lazy count
        that ``delete`` leaves on the device)."""
        if not isinstance(self._num_live, int):
            self._num_live = int(self._num_live)
        return self._num_live

    @property
    def num_appended(self) -> int:
        """Rows ever appended (live + tombstoned)."""
        return self._size

    def __len__(self) -> int:
        return self.size

    @property
    def plan(self) -> BinPlan:
        """Bin plan (and analytic E[recall], Eq. 13) of the packed layout."""
        if self._packed is not None:
            return self._packed.plan
        return plan_bins(
            self.capacity,
            packedlib.scan_k_for(self.spec, self.capacity),
            self.spec.recall_target,
            reduction_input_size_override=self.spec.reduction_input_size_override,
        )

    @property
    def expected_recall(self) -> float:
        """Analytic E[recall]: the bin plan's (Eq. 13), or on a clustered
        index the collision term over the scanned slots times the miss
        term."""
        _, decomp = self._cluster_recall()
        if decomp is not None:
            return decomp["expected_recall"]
        return self.plan.expected_recall

    @property
    def expected_recall_live(self) -> float:
        """The collision term times the measured served-query miss
        survival (``cluster.query_miss_rate`` counts, kept on the tables)
        once there are samples; else ``expected_recall``."""
        _, decomp = self._cluster_recall()
        if decomp is None:
            return float(self.plan.expected_recall)
        cs = self._packed.cluster if self._packed is not None else None
        rate = cs.served_miss_rate if cs is not None else None
        if rate is None:
            return float(decomp["expected_recall"])
        return float(decomp["collision_term"] * (1.0 - rate))

    def _cluster_plan_in_effect(self):
        """The ClusterPlan the search prunes with: the packed tables' own
        (None if there are none), or before a pack the kernel plan's
        enabled one."""
        if self._packed is not None:
            cs = self._packed.cluster
            return cs.plan if cs is not None else None
        kp = self._kernel_plan
        return kp.cluster if kp.cluster is not None and kp.cluster.enabled \
            else None

    def _cluster_recall(self):
        """The ClusterPlan in effect and its recall decomposition, or
        ``(None, None)``."""
        cp = self._cluster_plan_in_effect()
        if cp is None:
            return None, None
        k_scan = packedlib.scan_k_for(self.spec, cp.scan_rows)
        return cp, cp.recall_decomposition(k_scan)

    def _replan(self, *, n: int, m: Optional[int],
                pin_from: planlib.Plan) -> planlib.Plan:
        """``pin_from`` re-planned for ``n`` rows and a batch of ``m``
        (growth, ``explain(m=...)``): its tiles, backend and profile, the
        spec's recall accounting and tier, its provenance."""
        spec = self.spec
        plan = planlib.plan_search(
            n=n, d=self.dim, k=spec.k, m=m, metric=spec.metric,
            recall_target=spec.recall_target, dtype=spec.dtype or "float32",
            backend=pin_from.backend, device=pin_from.device,
            reduction_input_size_override=spec.reduction_input_size_override,
            storage=spec.storage, rescore=spec.rescore_enabled,
            cluster=spec.cluster, cluster_veto=self._cluster_vetoed,
            block_m=pin_from.block_m, max_block_n=pin_from.block_n,
            query_block=pin_from.query_block,
        )
        return dataclasses.replace(plan, source=pin_from.source)

    @property
    def kernel_plan(self) -> planlib.Plan:
        """The resolved kernel plan (``repro_torch.search.plan.Plan``):
        tiles, bin layout and the roofline prediction behind them."""
        return self._kernel_plan

    def explain(
        self,
        *,
        m: Optional[int] = None,
        measure: bool = False,
        validate_hlo: bool = False,
    ) -> dict:
        """The plan behind this index, with its predicted roofline position.

        Returns the resolved ``plan`` (tiles, bin layout, provenance, the
        kernels' split count), the ``predicted`` roofline placement (Eq.
        4–10: the binding wall and the time of a search, a bound since
        the profiles hold peaks) and the analytic ``expected_recall``.
        ``m`` re-evaluates the prediction for a batch of ``m`` queries
        (default: the plan's, or one ``query_block``).

        ``measure=True`` also times a batch of random queries on this
        index (``plan.time_search``) and reports the share of the
        predicted roof it reached.  ``validate_hlo=True`` reports
        ``{"skipped": ...}``: the FLOP count of a compiled program is not
        ported.
        """
        plan = self.kernel_plan
        if m is not None and m != plan.m:
            plan = self._replan(n=plan.n, m=m, pin_from=plan)
        sbytes = quant.storage_bytes(self.spec.storage)
        report = {
            "plan": plan.summary(),
            "backend": self._resolve_backend(),
            "expected_recall": plan.expected_recall,
            "predicted": {
                "device": plan.device,
                "flops": plan.flops,
                "hbm_bytes": plan.hbm_bytes,
                "cops": plan.cops,
                "i_mem": plan.i_mem,
                "i_cop": plan.i_cop,
                "attainable_flops": plan.attainable_flops,
                "bottleneck": plan.bottleneck,
                "wall_s": plan.predicted_s,
                "qps": plan.predicted_qps,
            },
            "storage": {
                "tier": self.spec.storage,
                "db_bytes_per_element": sbytes,
                "db_resident_bytes": self.capacity * self.dim * sbytes,
                "rescore": self.spec.rescore_enabled,
                "k_scan": plan.k_scan or plan.k,
                "predicted_hbm_bytes": plan.hbm_bytes,
                "fused_select": self.spec.fused_select_enabled,
            },
        }
        report["cluster"] = self._explain_cluster(plan, report)
        report["expected_recall_live"] = self.expected_recall_live
        if self._packed is not None:
            report["packed"] = {
                "n": self._packed.n,
                "db_shape": tuple(self._packed.db.shape),
                "bin_size": self._packed.bin_size,
                "block_n": self._packed.block_n,
            }
        m_eff = m or plan.m or plan.query_block
        if measure:
            g = torch.Generator(device=self.device).manual_seed(0)
            queries = torch.randn((m_eff, self.dim), generator=g,
                                  device=self.device)
            wall = planlib.time_search(self, queries, repeats=3)
            achieved = plan.flops / wall
            report["measured"] = {
                "wall_s": wall,
                "qps": m_eff / wall,
                "achieved_flops": achieved,
                "roofline_fraction": achieved / plan.attainable_flops,
            }
        if validate_hlo:
            report["hlo"] = {"skipped": "the compiled program's FLOP count "
                             "is not ported (ROADMAP queue A item 13)"}
        return report

    def _explain_cluster(self, plan: planlib.Plan, report: dict) -> dict:
        """``explain()``'s cluster block (the reference's keys); on a
        clustered index it also sets ``report["expected_recall"]`` to the
        product guarantee."""
        cp, decomp = self._cluster_recall()
        out = {"mode": self.spec.cluster, "enabled": cp is not None}
        if cp is None and plan.cluster is not None:
            out["predicted_speedup"] = plan.cluster.predicted_speedup
        if cp is None and plan.cluster_veto is not None:
            # the card's model prices the pruned scan at least as high as
            # the dense one at this batch
            out.update({
                "vetoed_by": "h100_cost_model",
                "predicted_pruned_s": plan.cluster_veto[0],
                "predicted_dense_s": plan.cluster_veto[1],
            })
        rejected = (self._packed.cluster_rejected_miss
                    if self._packed is not None else None)
        if cp is None and rejected is not None:
            out.update({
                "rejected_by": "sampled_miss_check",
                "sampled_miss": rejected,
                "miss_budget": (plan.cluster.miss_budget
                                if plan.cluster is not None else None),
            })
        if cp is not None:
            out.update({
                "num_clusters": cp.num_clusters,
                "probes": cp.probes,
                "rows_per_cluster": cp.rows_per_cluster,
                "spill_capacity": cp.spill_capacity,
                "scan_rows": cp.scan_rows,
                "scanned_fraction": cp.scanned_fraction,
                "predicted_speedup": cp.predicted_speedup,
                "collision_term": decomp["collision_term"],
                "miss_term": decomp["miss_term"],
                "expected_recall": decomp["expected_recall"],
            })
            report["expected_recall"] = decomp["expected_recall"]
            cs = self._packed.cluster if self._packed is not None else None
            if cs is not None:
                out["served_miss"] = cs.served_miss_report()
        return out

    def __repr__(self) -> str:
        return (
            f"Index(metric={self.spec.metric!r}, k={self.spec.k}, "
            f"backend={self._resolve_backend()!r}, size={self.size}, "
            f"capacity={self.capacity}, dim={self.dim}, device={self.device})"
        )

    # -- packed state --------------------------------------------------------

    def _resolve_backend(self) -> str:
        b = self.spec.backend
        return backends.default_backend(self.device) if b == "auto" else b

    def pack(self) -> packedlib.PackedState:
        """The packed operands, built once and then patched by add/delete."""
        if self._packed is None:
            self.pack_timings = {}
            self._packed = packedlib.pack_state(
                self._db, self._live, self.metric, self.spec,
                self._resolve_backend(), self.kernel_plan.cluster,
                timings=self.pack_timings,
            )
            self._bind_k_scan()
        return self._packed

    def _bind_k_scan(self) -> None:
        """Fix the scan's k for the current packed state: the over-fetch
        of a quantized tier, capped by the live rows (reading ``size``
        syncs with the device, so this runs at build, growth and an add
        that can lift the cap, never on delete or search)."""
        live = self.size if self.spec.rescore_enabled else None
        self._k_scan = packedlib.scan_k_for(self.spec, self._packed.n, live=live)

    @property
    def k_scan(self) -> int:
        """Candidates the scan keeps per query before the exact rescore
        (``spec.k`` on the f32 tier)."""
        self.pack()
        return self._k_scan

    # -- search --------------------------------------------------------------

    def search(self, queries) -> SearchResult:
        """Top-k neighbours of each query row: (M, D) -> SearchResult (M, k).

        If fewer than k live rows exist, the tail of a row holds
        MASK_VALUE-based sentinel values.

        >>> import torch
        >>> index = Index.build(torch.eye(16), metric="mips", k=3, device="cpu")
        >>> values, indices = index.search(torch.eye(16)[:4])
        >>> tuple(indices.shape), int(indices[0, 0])
        ((4, 3), 0)
        """
        queries = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if queries.ndim != 2:
            raise ValueError(f"queries must be (M, D), got {tuple(queries.shape)}")
        if queries.shape[1] != self.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != index dim {self.dim}"
            )
        if self.spec.dtype is not None:
            queries = queries.to(getattr(torch, self.spec.dtype))
        on_kernels = self._resolve_backend() == "cuda" and self.device.type == "cuda"
        if on_kernels or queries.shape[0] <= self.spec.query_block:
            return SearchResult(*self._search_block(queries))
        return self._search_stream(queries)

    def _search_block(self, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One dispatch: :meth:`_search_ops`, counted in
        ``DISPATCH_COUNTS``."""
        backends.DISPATCH_COUNTS.inc(self._resolve_backend())
        return self._search_ops(q)

    def _search_ops(self, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The search of one query block (what a search graph captures)."""
        backend = self._resolve_backend()
        pk = self.pack()
        spec = self.spec
        operands = (q, pk.db, pk.bias, pk.scale, pk.rescore_db, pk.rescore_bias)
        common = dict(metric=spec.metric, k=spec.k, k_scan=self._k_scan,
                      aggregate_to_topk=spec.aggregate_to_topk,
                      use_bitonic=spec.use_bitonic)
        if pk.cluster is not None:
            # Both backends run the pruned gathered program, with the
            # statics of the plan the tables were built with.
            cplan = pk.cluster.plan
            return backends.cluster_search_quant(
                *operands, *pk.cluster.operands(), probes=cplan.probes,
                target_scan=cplan.target_scan, int4_packed=pk.int4_packed,
                **common,
            )
        if backend == "torch":
            return backends.dense_search_quant(
                *operands, recall_target=spec.recall_target,
                reduction_input_size_override=spec.reduction_input_size_override,
                **common,
            )
        return backends.cuda_search_packed_quant(
            *operands, n=pk.n, bin_size=pk.bin_size,
            fused_select=spec.fused_select_enabled,
            int4_packed=pk.int4_packed, **common,
        )

    @property
    def query_dtype(self) -> torch.dtype:
        """The dtype a search computes its queries in (``spec.dtype``)."""
        return getattr(torch, self.spec.dtype or "float32")

    def search_graph(self, m: int) -> backends.SearchGraph:
        """The CUDA graph of one search of an (m, D) block of
        ``query_dtype`` rows, captured at its first use
        (``backends.capture_search``): copy queries into its ``queries``,
        replay it with ``replay_graph``, read ``values``/``indices``.  A
        mutation that reallocates an operand the graph reads (growth, a
        re-bound ``k_scan``, a recluster, a full re-pack) makes the next
        call recapture; a patch in place (an add without growth, a
        delete) keeps it.  Only on a CUDA device."""
        if self.device.type != "cuda":
            raise RuntimeError(
                f"search graphs are CUDA graphs; this index is on {self.device}")
        pk = self.pack()
        signature = (self._k_scan, pk.n, pk.bin_size) + tuple(
            (t.data_ptr(), tuple(t.shape)) for t in pk.operands()
            if t is not None)
        dtype = self.query_dtype
        return self._graphs.get(
            signature, m, dtype,
            lambda: backends.capture_search(self._search_ops, m, self.dim,
                                            dtype, self.device))

    def replay_graph(self, graph: backends.SearchGraph) -> None:
        """Replay a graph of :meth:`search_graph` on the current stream:
        one dispatch (``DISPATCH_COUNTS``) and one ``replays`` in
        ``cache_info()``."""
        backends.DISPATCH_COUNTS.inc(self._resolve_backend())
        self._graphs.replay(graph)

    def cache_info(self) -> dict:
        """The search graphs' counters (``backends.GraphCache.info``): the
        reference's ``hits``/``misses``/``entries``, and ``captures``,
        ``replays`` and ``invalidations``; zero entries on the CPU."""
        return self._graphs.info()

    def telemetry(self) -> dict:
        """One JSON-serializable telemetry snapshot, index gauges included.

        Refreshes this index's gauges in the process-global registry
        (size, capacity, ``expected_recall`` and ``expected_recall_live``,
        labeled by backend, storage and cluster), then returns
        ``telemetry.export_json()``."""
        reg = telemetry.registry()
        labels = {
            "backend": self._resolve_backend(),
            "storage": self.spec.storage,
            "cluster": (
                "on" if self._cluster_plan_in_effect() is not None else "off"
            ),
        }
        reg.set_gauge("repro_index_size", self.size, **labels)
        reg.set_gauge("repro_index_capacity", self.capacity, **labels)
        reg.set_gauge("repro_index_expected_recall", self.expected_recall,
                      **labels)
        reg.set_gauge("repro_index_expected_recall_live",
                      self.expected_recall_live, **labels)
        return telemetry.export_json()

    def _search_stream(self, queries: torch.Tensor) -> SearchResult:
        """The plain paths' executor: one ``_search_block`` per
        ``query_block`` rows (each result row depends on its query only)."""
        qb = self.spec.query_block
        parts = [self._search_block(queries[s : s + qb])
                 for s in range(0, queries.shape[0], qb)]
        return SearchResult(
            torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts])
        )

    # -- updates (the paper's frequent-update path) --------------------------

    def add(self, rows) -> "Index":
        """Append rows; grows capacity in ``capacity_block`` steps.

        Only the appended slice is metric-prepared (and quantized);
        growth re-lays-out the packed operands (one device copy, bins and
        kernel plan re-planned for the new capacity) without re-preparing
        existing rows.  The scan's k is bound anew on growth and whenever
        the bound value is below the uncapped over-fetch.
        """
        faults.fire("index.add")  # before any state changes: all or nothing
        rows = torch.as_tensor(rows, dtype=torch.float32, device=self.device)
        rows = torch.atleast_2d(rows)
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise ValueError(
                f"rows must be (R, {self.dim}), got {tuple(rows.shape)}"
            )
        r = rows.shape[0]
        required = self._size + r
        had_packed = self._packed is not None
        grew = False
        if not self.metric.rowwise:
            # Coupled preparation: the incremental patches are undefined.
            self._packed = None
        if required > self.capacity:
            # Linear growth, not doubling: spare capacity is masked but
            # still scored on every search.
            new_cap = round_up(required, self._capacity_block)
            grow = new_cap - self.capacity
            self._db = F.pad(self._db, (0, 0, 0, grow))
            self._live = torch.cat([
                self._live,
                torch.zeros((grow,), dtype=torch.bool, device=self.device),
            ])
            if self._packed is not None:
                self._packed = self._packed.relayout(
                    self._packed.backend, new_cap, self.spec
                )
                grew = True
            # bins and prediction re-planned for the grown row space (as
            # the packed relayout re-plans its bins), the same tiles
            p = self._kernel_plan
            self._kernel_plan = self._replan(n=new_cap, m=p.m or None,
                                             pin_from=p)
            # an index that grew past the crossover is priced now
            self._cluster_vetoed = _cluster_pin(self._kernel_plan)
        self._db[self._size : required] = rows
        self._live[self._size : required] = True
        if self._packed is not None:
            self._packed.update_rows(self._size, rows, self.metric)
        self._size = required
        self._num_live = self._num_live + r
        if had_packed and self._packed is None:
            self.pack()
        elif grew or (self._packed is not None and self._k_scan
                      < packedlib.scan_k_for(self.spec, self._packed.n)):
            # Growth, or the over-fetch capped below its full value by the
            # live rows this add raises: bind it anew.
            self._bind_k_scan()
        pk = self._packed
        if pk is not None and pk.cluster is not None \
                and pk.cluster.needs_recluster:
            # The lazy recluster: the spill block grew past the planner's
            # threshold, so the tables are rebuilt for the current capacity
            # (a vetoed index has no tables to rebuild).
            cplan = planlib.plan_clusters(
                n=self.capacity,
                k_scan=packedlib.scan_k_for(self.spec, self.capacity),
                recall_target=self.spec.recall_target,
            )
            if cplan.enabled:
                packedlib.rebuild_cluster(pk, self._live, self.metric, cplan)
        return self

    def delete(self, ids) -> "Index":
        """Tombstone rows by index (their ids never appear in later
        results).  Repeated ids count once; ids outside the capacity
        raise."""
        faults.fire("index.delete")  # before any patch: all or nothing
        ids = torch.as_tensor(ids, dtype=torch.int64, device=self.device).reshape(-1)
        if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= self.capacity):
            raise IndexError(
                f"delete ids must lie in [0, {self.capacity}), got "
                f"[{int(ids.min())}, {int(ids.max())}]"
            )
        self._live[ids] = False
        # Recount rather than decrement: ids may repeat.  Kept on the
        # device; ``size`` reads it.
        self._num_live = self._live.sum()
        if self._packed is not None:
            self._packed.delete_rows(ids)
        return self

    # -- crash-safe snapshots ------------------------------------------------

    def save(self, path: str) -> str:
        """Write a crash-safe snapshot directory; returns the committed path.

        The raw database and live mask and the packed state — stored rows,
        fused bias, scale, rescore tail, cluster tables — through
        ``repro_torch.checkpoint.save_snapshot`` (tmp dir, fsync, atomic
        rename), in the reference's format: its ``META.json`` stamp and
        array names, its backend names in the spec, and its layout
        (``packed.snapshot_state``), so ``repro.search.Index.restore``
        reads it wherever the layouts agree.  :meth:`restore` re-runs no
        preparation, quantization or k-means.
        """
        from repro_torch.checkpoint.checkpoint import save_snapshot

        faults.fire("index.save")
        telemetry.registry().inc("repro_snapshot_saves_total")
        pk = self.pack()
        arrays, pk_meta = packedlib.snapshot_state(pk)
        arrays["db"] = self._db
        arrays["live"] = self._live
        spec = self.spec.to_json_dict()
        spec["backend"] = _REFERENCE_BACKEND[spec["backend"]]
        meta = {
            "format": SNAPSHOT_FORMAT,
            "version": SNAPSHOT_VERSION,
            "spec": spec,
            "size": self._size,
            "num_live": self.size,
            "capacity_block": self._capacity_block,
            "packed": pk_meta,
        }
        return save_snapshot(path, arrays, meta)

    @classmethod
    def restore(cls, path: str, *, device=None) -> "Index":
        """Load a snapshot written by :meth:`save` or by the reference's
        ``Index.save`` onto ``device`` (default ``"cuda"``, as ``build``).

        No preparation, quantization or k-means runs: the stored arrays
        are laid out for the port's backend (``packed.state_from_arrays``;
        a pallas-layout int4 database is unpacked and re-laid out).  The
        spec's tiles become the port's fixed 128 x 128, and the kernel
        plan is the model's for the device's profile, its cluster decision
        pinned to the restored tables.

        >>> import os, tempfile, torch
        >>> idx = Index.build(torch.eye(32), metric="mips", k=2, device="cpu")
        >>> with tempfile.TemporaryDirectory() as d:
        ...     _ = idx.save(os.path.join(d, "snap"))
        ...     r = Index.restore(os.path.join(d, "snap"), device="cpu")
        >>> r.size == idx.size
        True
        """
        from repro_torch.checkpoint.checkpoint import load_snapshot

        meta, arrays = load_snapshot(path)
        if meta.get("format") != SNAPSHOT_FORMAT:
            raise ValueError(
                f"{path} is not an index snapshot "
                f"(format={meta.get('format')!r})"
            )
        if int(meta.get("version", 0)) > SNAPSHOT_VERSION:
            raise ValueError(
                f"snapshot version {meta['version']} is newer than this "
                f"code's {SNAPSHOT_VERSION} — upgrade to restore it"
            )
        fields = dict(meta["spec"])
        if fields["backend"] not in _PORT_BACKEND:
            raise NotImplementedError(
                f"backend={fields['backend']!r}: sharded indexes are not "
                "ported yet (ROADMAP queue A item 11)"
            )
        fields["backend"] = _PORT_BACKEND[fields["backend"]]
        fields["block_m"] = fields["max_block_n"] = None  # the fixed tiles
        spec = SearchSpec.from_json_dict(fields)
        device = _resolve_device(device)
        pk = packedlib.state_from_arrays(arrays, meta["packed"], spec, device)
        db = packedlib._tensor(arrays["db"], device).to(torch.float32)
        live = packedlib._tensor(np.asarray(arrays["live"], bool), device)
        plan_backend = (backends.default_backend(device)
                        if spec.backend == "auto" else spec.backend)
        kernel_plan = planlib.plan_search(
            n=db.shape[0], d=db.shape[1], k=spec.k, metric=spec.metric,
            recall_target=spec.recall_target, dtype=spec.dtype or "float32",
            backend=plan_backend,
            device=planlib.detect_device(None, device=device),
            reduction_input_size_override=spec.reduction_input_size_override,
            query_block=spec.query_block, storage=spec.storage,
            rescore=spec.rescore_enabled, cluster=spec.cluster,
            cluster_veto=False if pk.cluster is not None else None,
        )
        index = cls(
            kernel_plan.to_spec(spec), db, live, size=int(meta["size"]),
            num_live=int(meta["num_live"]),
            capacity_block=int(meta["capacity_block"]),
            kernel_plan=kernel_plan,
        )
        index._packed = pk
        index._bind_k_scan()
        telemetry.registry().inc("repro_snapshot_restores_total")
        return index
