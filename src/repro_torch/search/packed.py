"""PackedState: device-resident, backend-layout search operands.

Port of ``src/repro/search/packed.py``.  At build and mutation time
(never at search time) it holds

  * the metric-prepared database in its storage tier
    (``repro_torch.search.quant``) and the backend's layout — for
    ``"cuda"`` padded to the kernels' tiling contract: D to a multiple of
    128 for every tier (int4 rows are then packed two codes per byte, 64
    bytes at D=128; the reference's TPU layout pads int4 to 256 lanes),
    N to a multiple of ``block_n = max(bin_size, BLOCK_N)``;
  * the fused bias row — metric bias (of the stored values), tombstones
    and tail mask in one additive term;
  * for int8/int4, the per-row scale (0 on the padded tail);
  * for a quantized tier with rescoring, the rescore tail: the
    full-precision prepared rows (n, d) and their own fused bias (n,);
  * the bin plan the layout was derived from (for a quantized tier,
    planned for the over-fetched ``quant.scan_k``).

Rows are cast to the spec's compute dtype (``SearchSpec.dtype``) before
preparation: with ``"bfloat16"`` the f32 tier stores bf16 rows, and a
quantized tier quantizes the bf16-cast rows (its rescore tail holds them
widened to f32).

A clustered index (``repro_torch.search.cluster``) adds a
``ClusterState`` of side tables (centroids, slot tables, a spill block);
the packed arrays keep the row order of the unclustered layout.  The
build checks the tables' measured miss rate and, past the threshold,
drops them (``cluster_rejected_miss``): the layout is then the
``cluster="off"`` one.

Mutations, as in the reference: ``update_rows`` prepares (and quantizes)
only an appended slice and slots it into the cluster tables,
``delete_rows`` patches only bias entries (the rescore bias too),
``relayout`` copies into a new capacity without re-preparing rows (and
carries the tables), ``rebuild_cluster`` is the lazy recluster, and
``pack_state`` is the only full pack (``pack_host_state`` its form for a
host-resident index: the rows prepared on the compute device a chunk at
a time, the state kept in host memory, pinned by ``pin_state``).
Unlike the reference's immutable arrays, ``update_rows`` and
``delete_rows`` write into the tensors in place.  ``PACK_EVENTS`` counts
each kind of work by name.

A sharded index (``Index.shard``) holds a :class:`ShardedState`: one
PackedState a database shard over ``n_local = n / shards`` rows, each on
its shard's device in the layout of the index's backend before it was
sharded (``"cuda"`` on a card by default: the kernels; on the CPU the
``"cuda"`` layout runs their plain versions), its bins planned for the
shard's rows with the recall accounted against the global N
(:func:`shard_bins`, the reference's per-shard plan), so no bin or tile
crosses a shard.  The cluster tables are global (user row ids) and
replicated to each device that searches.  ``relayout("sharded", ...)``
of either state builds one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.binning import BinPlan, plan_bins, round_up
from repro_torch.kernels import partial_reduce as kernels
from repro_torch.search import cluster as clusterlib
from repro_torch.search import quant
from repro_torch.search.backends import default_backend
from repro_torch.search.metrics import Metric
from repro_torch.search.spec import SearchSpec
from repro_torch.search.stages import MASK_VALUE
from repro_torch.search import telemetry

__all__ = [
    "PACK_EVENTS",
    "PackedState",
    "ShardedState",
    "fuse_bias",
    "pack_host_state",
    "pack_state",
    "pin_state",
    "rebuild_cluster",
    "reset_pack_events",
    "restore_state",
    "scan_k_for",
    "shard_bins",
    "snapshot_state",
    "state_from_arrays",
]

# event name -> packing work performed ("full_pack", "relayout",
# "rows_updated", "bias_patched", "restore", and on clustered layouts
# "cluster_built", "cluster_rejected", "cluster_assigned", "recluster").
PACK_EVENTS = telemetry.AtomicCounter()
telemetry.registry().register_counter_dict(
    "repro_pack_events_total", PACK_EVENTS, "event",
    "packing/cluster/restore work performed (repro_torch.search.packed)",
)


def reset_pack_events() -> None:
    """Zero ``PACK_EVENTS`` (the reference's deprecated alias; prefer
    ``telemetry.reset_all()``)."""
    PACK_EVENTS.clear()


def fuse_bias(
    metric_bias: Optional[torch.Tensor],
    live: Optional[torch.Tensor] = None,
    *,
    num_rows: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """Fuse metric bias and tombstone mask into one additive (n,) f32 row.

    ``live=None`` means every row is live.  The clamp at ``MASK_VALUE``
    keeps the row finite, so the score paths stay NaN-free while a
    masked row still loses every comparison.
    """
    if live is None:
        if metric_bias is None:
            return torch.zeros((num_rows,), dtype=torch.float32, device=device)
        return torch.clamp(metric_bias.to(torch.float32), min=MASK_VALUE)
    tomb = torch.where(live, 0.0, MASK_VALUE).to(torch.float32)
    if metric_bias is None:
        return tomb
    return torch.clamp(tomb + metric_bias.to(torch.float32), min=MASK_VALUE)


@dataclasses.dataclass
class PackedState:
    """Operands for one (backend, capacity, spec) layout.

    Attributes:
      backend: "torch" or "cuda" — decides the layout.
      db: metric-prepared stored rows; (n, d) for "torch", padded
        (n_pad, d_pad) for "cuda" — (n_pad, d_pad / 2) int8 nibble pairs
        for int4 there.
      bias: fused bias row; (n,) for "torch", (1, n_pad) for "cuda" with
        the tail pre-masked to ``MASK_VALUE``.
      n: logical row space (== Index.capacity).
      d: logical feature dim (before lane padding).
      plan: the BinPlan of the layout.
      bin_size / block_n: kernel layout constants (block_n == 0 for
        "torch").
      storage: the ``quant`` tier ``db`` is stored in.
      scale: per-row scale of int8/int4 — (n,), or (1, n_pad) for "cuda";
        None for the other tiers.
      rescore_db / rescore_bias: the rescore tail, (n, d) f32 rows and
        (n,) fused bias (exact metric bias + tombstones), in gather layout
        on every backend; None for f32 or with rescoring off.
      compute_dtype: the dtype rows are cast to before preparation; an
        appended slice repeats the same cast-then-prepare order.
      cluster: the pruning side tables, or None (unclustered layout).
      cluster_rejected_miss: the measured miss rate that made the build
        drop the tables the planner enabled, else None.
    """

    backend: str
    db: torch.Tensor
    bias: torch.Tensor
    n: int
    d: int
    plan: BinPlan
    bin_size: int
    block_n: int
    storage: str = "f32"
    scale: Optional[torch.Tensor] = None
    rescore_db: Optional[torch.Tensor] = None
    rescore_bias: Optional[torch.Tensor] = None
    compute_dtype: str = "float32"
    cluster: Optional[clusterlib.ClusterState] = None
    cluster_rejected_miss: Optional[float] = None

    @property
    def int4_packed(self) -> bool:
        """The int4 codes sit two per byte (the "cuda" layout)."""
        return self.storage == "int4" and self.backend == "cuda"

    def rows(self) -> torch.Tensor:
        """The prepared stored rows without layout padding: (n, d), int4
        as canonical codes (one per byte)."""
        if self.int4_packed:
            return quant.unpack_int4_rows(self.db[: self.n])[:, : self.d]
        return self.db[: self.n, : self.d]

    @staticmethod
    def _flat(row: torch.Tensor) -> torch.Tensor:
        """A per-row array of either layout, (n,) or (1, n_pad), as 1-D."""
        return row[0] if row.ndim == 2 else row

    def bias_row(self) -> torch.Tensor:
        """The fused bias without layout padding: (n,)."""
        return self._flat(self.bias)[: self.n]

    def scale_row(self) -> Optional[torch.Tensor]:
        """The per-row scale without layout padding: (n,) or None."""
        return None if self.scale is None else self._flat(self.scale)[: self.n]

    def rescore_tail(self):
        """``(rescore_db, rescore_bias)`` without layout padding, or
        ``(None, None)``."""
        if self.rescore_db is None:
            return None, None
        return self.rescore_db[: self.n], self.rescore_bias[: self.n]

    def exact_rows_bias(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-precision prepared rows and fused bias, (n, d) / (n,): the
        f32 tier's own rows, a quantized tier's rescore tail, or (rescore
        off) the dequantized stored rows; what the lazy recluster and the
        miss monitor score with."""
        if self.storage == "f32":
            return self.rows(), self.bias_row()
        if self.rescore_db is not None:
            return self.rescore_db[: self.n], self.rescore_bias[: self.n]
        return quant.dequantize_rows(self.rows(), self.scale_row()), self.bias_row()

    def operands(self) -> Tuple[Optional[torch.Tensor], ...]:
        """The positional operands a search consumes: ``(db, bias)`` for
        f32, ``(db, bias, scale, rescore_db, rescore_bias)`` for a
        quantized tier (entries may be None), then the four side tables on
        a clustered layout."""
        if self.storage == "f32":
            base = (self.db, self.bias)
        else:
            base = (self.db, self.bias, self.scale, self.rescore_db,
                    self.rescore_bias)
        return base + (self.cluster.operands() if self.cluster else ())

    def update_rows(self, start: int, rows: torch.Tensor, metric: Metric):
        """Prepare (and quantize) an appended row slice and write it in
        place, O(r·D) — the same cast-prepare-quantize order as the full
        pack, so both give the same codes — and slot it into the cluster
        tables (nearest centroid, O(r·C))."""
        rows = rows.to(getattr(torch, self.compute_dtype))
        if self.storage == "f32":
            prepped, metric_bias = metric.prepare_update(rows)
            exact_slice = prepped
        else:
            qr = metric.prepare_update_storage(rows, self.storage)
            prepped, metric_bias = qr.rows, qr.bias
            exact_slice = qr.exact_rows
        r = prepped.shape[0]
        d_pad = self.db.shape[1] * (2 if self.int4_packed else 1)
        prepped = F.pad(prepped, (0, d_pad - prepped.shape[1]))
        if self.int4_packed:  # canonical codes, two per byte
            prepped = quant.pack_int4_rows(prepped)
        # a host-resident state takes rows prepared on the compute device
        home = self.db.device
        self.db[start : start + r] = prepped.to(home)
        self.bias_row()[start : start + r] = fuse_bias(
            metric_bias, num_rows=r, device=rows.device
        ).to(home)
        if self.storage != "f32":
            if self.scale is not None:
                self.scale_row()[start : start + r] = qr.scale.to(home)
            if self.rescore_db is not None:
                self.rescore_db[start : start + r] = qr.exact_rows.to(home)
                self.rescore_bias[start : start + r] = fuse_bias(
                    qr.exact_bias, num_rows=r, device=rows.device
                ).to(home)
        if self.cluster is not None:
            clusterlib.assign_rows(self.cluster, exact_slice, start)
            PACK_EVENTS.inc("cluster_assigned")
        PACK_EVENTS.inc("rows_updated")

    def delete_rows(self, ids: torch.Tensor):
        """Tombstone rows: set their bias entries to ``MASK_VALUE``, in the
        rescore bias too (the exact pass must not resurrect them)."""
        self.bias_row()[ids] = MASK_VALUE
        if self.rescore_bias is not None:
            self.rescore_bias[ids] = MASK_VALUE
        PACK_EVENTS.inc("bias_patched")

    def relayout(self, backend: str, new_n: int, spec: SearchSpec, *,
                 grid=None, k_scan: Optional[int] = None):
        """Copy into a new capacity and/or backend, reusing prepared rows.

        The grown region is dead (bias ``MASK_VALUE``, scale 0) until
        ``update_rows`` writes it; the bin plan is re-derived for
        ``new_n``.  The cluster tables hold user row ids, which a relayout
        never renumbers: they are carried as they are.  ``"sharded"``
        returns a :class:`ShardedState` over the devices of ``grid``
        (``Mesh.device_grid``), its bins planned for ``k_scan``, each
        shard in this state's layout.
        """
        if backend == "sharded":
            return ShardedState.split(self, grid, new_n, spec, k_scan,
                                      self.backend)
        rows, bias, scale, rescore_db, rescore_bias = _grown(self, new_n)
        PACK_EVENTS.inc("relayout")
        out = _layout(backend, rows, bias, new_n, self.d, spec, scale=scale,
                      rescore_db=rescore_db, rescore_bias=rescore_bias,
                      compute_dtype=self.compute_dtype)
        out.cluster = self.cluster
        return out


def _grown(state, new_n: int):
    """A state's logical (rows, bias, scale, rescore_db, rescore_bias),
    padded with dead rows to ``new_n``."""
    rows, bias, scale = state.rows(), state.bias_row(), state.scale_row()
    rescore_db, rescore_bias = state.rescore_tail()
    if new_n > state.n:
        grow = new_n - state.n
        rows = F.pad(rows, (0, 0, 0, grow))
        bias = F.pad(bias, (0, grow), value=MASK_VALUE)
        if scale is not None:
            scale = F.pad(scale, (0, grow))
        if rescore_db is not None:
            rescore_db = F.pad(rescore_db, (0, 0, 0, grow))
            rescore_bias = F.pad(rescore_bias, (0, grow), value=MASK_VALUE)
    return rows, bias, scale, rescore_db, rescore_bias


def shard_bins(n_local: int, k_scan: int, recall_target: float,
               global_n: int) -> BinPlan:
    """One shard's bin plan (the reference's sharded search): the shard's
    rows, ``min(k_scan, n_local)``, recall accounted against the global
    N."""
    return plan_bins(n_local, min(k_scan, n_local), recall_target,
                     reduction_input_size_override=global_n)


@dataclasses.dataclass
class ShardedState:
    """The packed state of a sharded index: one :class:`PackedState` a
    database shard (``shards[j]`` over rows ``[j * n_local, (j + 1) *
    n_local)`` on ``grid[0][j]``), the global cluster tables, and the
    layout the reference's ``"sharded"`` state reports (``plan`` over the
    global N, ``block_n`` 0).

    ``k_scan`` is what each shard's bins are planned for
    (:func:`shard_bins`); ``layout`` is every shard's (``"torch"`` or
    ``"cuda"``).  ``grid`` is the mesh's ``[batch group][shard]``
    devices; :meth:`replica` gives shard ``j`` on group ``g``'s device
    (the shard itself where that is its device, else a copy made at the
    first search after a mutation).
    """

    shards: list
    grid: list
    n: int
    d: int
    plan: BinPlan
    storage: str
    compute_dtype: str
    k_scan: int
    layout: str
    cluster: Optional[clusterlib.ClusterState] = None
    cluster_rejected_miss: Optional[float] = None
    backend: str = "sharded"
    block_n: int = 0
    _copies: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def split(cls, state, grid, new_n: int, spec: SearchSpec,
              k_scan: int, layout: str) -> "ShardedState":
        """Lay ``state`` (either kind) out as ``layout`` shards over
        ``grid``'s database shards, padded with dead rows to ``new_n`` (a
        multiple of the shard count); no row is prepared again."""
        count = len(grid[0])
        if new_n % count:
            raise ValueError(f"{new_n} rows do not split into {count} shards")
        rows, bias, scale, rescore_db, rescore_bias = _grown(state, new_n)
        n_local = new_n // count
        bins = shard_bins(n_local, k_scan, spec.recall_target, new_n)
        shards = []
        for j, dev in enumerate(grid[0]):
            part = slice(j * n_local, (j + 1) * n_local)

            def on(t):
                return None if t is None else t[part].to(dev)
            shards.append(_layout(
                layout, on(rows), on(bias), n_local, state.d,
                spec, scale=on(scale), rescore_db=on(rescore_db),
                rescore_bias=on(rescore_bias),
                compute_dtype=state.compute_dtype, bins=bins))
        PACK_EVENTS.inc("relayout")
        return cls(
            shards=shards, grid=grid, n=new_n, d=state.d,
            plan=plan_bins(new_n, scan_k_for(spec, new_n), spec.recall_target,
                           reduction_input_size_override=
                           spec.reduction_input_size_override),
            storage=state.storage, compute_dtype=state.compute_dtype,
            k_scan=k_scan, layout=layout, cluster=state.cluster,
            cluster_rejected_miss=state.cluster_rejected_miss)

    @property
    def n_local(self) -> int:
        return self.n // len(self.shards)

    @property
    def bin_size(self) -> int:
        return self.plan.bin_size

    @property
    def device(self) -> torch.device:
        """The controller's device: where results are gathered."""
        return self.grid[0][0]

    @property
    def int4_packed(self) -> bool:
        return False  # the logical arrays hold one code a byte

    def _cat(self, part) -> Optional[torch.Tensor]:
        pieces = [part(s) for s in self.shards]
        if pieces[0] is None:
            return None
        return torch.cat([p.to(self.device) for p in pieces])

    def rows(self) -> torch.Tensor:
        return self._cat(PackedState.rows)

    def bias_row(self) -> torch.Tensor:
        return self._cat(PackedState.bias_row)

    def scale_row(self) -> Optional[torch.Tensor]:
        return self._cat(PackedState.scale_row)

    def rescore_tail(self):
        return (self._cat(lambda s: s.rescore_tail()[0]),
                self._cat(lambda s: s.rescore_tail()[1]))

    def exact_rows_bias(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self._cat(lambda s: s.exact_rows_bias()[0]),
                self._cat(lambda s: s.exact_rows_bias()[1]))

    def operands(self) -> Tuple[Optional[torch.Tensor], ...]:
        """Every shard's operands, then the cluster tables."""
        ops = tuple(t for s in self.shards for t in s.operands())
        return ops + (self.cluster.operands() if self.cluster else ())

    def replica(self, g: int, j: int) -> PackedState:
        """Shard ``j`` on the device of batch group ``g``."""
        dev, shard = self.grid[g][j], self.shards[j]
        if shard.db.device == dev:
            return shard
        key = (g, j)
        if key not in self._copies:
            moved = {name: getattr(shard, name).to(dev)
                     for name in ("db", "bias", "scale", "rescore_db",
                                  "rescore_bias")
                     if getattr(shard, name) is not None}
            self._copies[key] = dataclasses.replace(shard, **moved)
        return self._copies[key]

    def cluster_operands(self, device) -> tuple:
        """The cluster tables on ``device`` (replicated: every shard ranks
        the same centroids)."""
        if self.cluster.centroids.device == device:
            return self.cluster.operands()
        key = ("cluster", id(self.cluster), str(device))
        if key not in self._copies:
            self._copies[key] = tuple(t.to(device)
                                      for t in self.cluster.operands())
        return self._copies[key]

    def _touched(self) -> None:
        self._copies.clear()  # copies are remade at the next search

    def update_rows(self, start: int, rows: torch.Tensor, metric: Metric):
        """Prepare an appended slice into the shards that own its rows
        (``divmod(pos, n_local)``), then slot its exact rows into the
        global cluster tables."""
        n_local = self.n_local
        stop = start + rows.shape[0]
        for j in range(start // n_local, (stop - 1) // n_local + 1):
            lo, hi = max(start, j * n_local), min(stop, (j + 1) * n_local)
            shard = self.shards[j]
            shard.update_rows(lo - j * n_local,
                              rows[lo - start : hi - start].to(shard.db.device),
                              metric)
        if self.cluster is not None:
            exact = self._cat(lambda s: s.exact_rows_bias()[0])[start:stop]
            clusterlib.assign_rows(self.cluster, exact, start)
            PACK_EVENTS.inc("cluster_assigned")
        self._touched()

    def delete_rows(self, ids: torch.Tensor):
        """Tombstone rows by global id, in the shards that own them."""
        owner = torch.div(ids, self.n_local, rounding_mode="floor")
        for j, shard in enumerate(self.shards):
            local = ids[owner == j] - j * self.n_local
            if local.numel():
                shard.delete_rows(local.to(shard.db.device))
        self._touched()

    def relayout(self, backend: str, new_n: int, spec: SearchSpec, *,
                 grid=None, k_scan: Optional[int] = None) -> "ShardedState":
        """Growth: the shards re-split for ``new_n`` rows (a sharded state
        stays sharded)."""
        if backend != "sharded":
            raise ValueError(f"a sharded state relays out as 'sharded', "
                             f"not {backend!r}")
        return ShardedState.split(self, grid or self.grid, new_n, spec,
                                  self.k_scan if k_scan is None else k_scan,
                                  self.layout)

    def rebin(self, k_scan: int, spec: SearchSpec) -> "ShardedState":
        """The state with its shards' bins planned for ``k_scan`` (a
        re-split only where a shard's bin size changes)."""
        bins = shard_bins(self.n_local, k_scan, spec.recall_target, self.n)
        if all(s.bin_size == bins.bin_size for s in self.shards):
            for s in self.shards:
                s.plan = bins
            self.k_scan = k_scan
            return self
        return ShardedState.split(self, self.grid, self.n, spec, k_scan,
                                  self.layout)


def scan_k_for(spec: SearchSpec, n: int, live: Optional[int] = None) -> int:
    """The k the scan's bin layout is planned for.

    A quantized tier with rescoring over-fetches (``quant.scan_k``) so the
    exact second pass can restore the Eq. 13–14 guarantee; everything
    else plans for the user's k.  ``live`` caps the over-fetch at the live
    row count, floored at ``spec.k`` (the reference binds it when it
    builds a search program; ``Index`` binds it when its packed state
    changes).
    """
    if spec.rescore_enabled:
        ks = quant.scan_k(spec.storage, spec.k, n=n)
        if live is not None:
            ks = max(spec.k, min(ks, max(int(live), 0)))
        return ks
    return spec.k


def _layout(
    backend: str,
    rows: torch.Tensor,
    bias: torch.Tensor,
    n: int,
    d: int,
    spec: SearchSpec,
    *,
    scale: Optional[torch.Tensor] = None,
    rescore_db: Optional[torch.Tensor] = None,
    rescore_bias: Optional[torch.Tensor] = None,
    compute_dtype: str = "float32",
    bins: Optional[BinPlan] = None,
) -> PackedState:
    """Lay prepared (rows, bias, scale) out in the backend's shape (new
    tensors: the state never aliases the caller's rows).  The rescore tail
    keeps its gather layout on every backend.  ``bins`` overrides the bin
    plan (a shard's, :func:`shard_bins`)."""
    plan = bins or plan_bins(
        n, scan_k_for(spec, n), spec.recall_target,
        reduction_input_size_override=spec.reduction_input_size_override,
    )
    bin_size = plan.bin_size
    tail = dict(storage=spec.storage,
                rescore_db=None if rescore_db is None else rescore_db.clone(),
                rescore_bias=None if rescore_bias is None else rescore_bias.clone(),
                compute_dtype=compute_dtype)
    if backend == "cuda":
        block_n = max(bin_size, kernels.BLOCK_N)
        n_pad = round_up(max(n, block_n), block_n)
        # Zero pad lanes are exact for dot products (a zero int4 code
        # dequantizes to 0); int4 codes then go two per byte.
        db = F.pad(rows, (0, round_up(d, 128) - d, 0, n_pad - n))
        if spec.storage == "int4":
            db = quant.pack_int4_rows(db)
        full = F.pad(bias.to(torch.float32), (0, n_pad - n), value=MASK_VALUE)
        if scale is not None:
            # Padded-tail scale is 0: tail scores become 0 * dot + MASK.
            scale = F.pad(scale, (0, n_pad - n))[None, :].contiguous()
        return PackedState(
            backend=backend, db=db, bias=full[None, :].contiguous(), n=n,
            d=d, plan=plan, bin_size=bin_size, block_n=block_n, scale=scale,
            **tail,
        )
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    return PackedState(
        backend=backend, db=rows.clone(), bias=bias.to(torch.float32).clone(),
        n=n, d=d, plan=plan, bin_size=bin_size, block_n=0,
        scale=None if scale is None else scale.clone(), **tail,
    )


def _prepare(database: torch.Tensor, live: Optional[torch.Tensor],
             metric: Metric, spec: SearchSpec) -> dict:
    """The cast to ``spec.dtype``, metric preparation and (for a quantized
    tier) quantization of ``database`` rows: the stored ``rows``, their
    fused ``bias``, ``scale``, the rescore tail (``rescore_db``,
    ``rescore_bias``; with rescoring on), the full-precision
    ``exact_rows`` and their fused ``exact_bias``, and the
    ``compute_dtype``."""
    n = database.shape[0]
    db = database
    if spec.dtype is not None:
        db = db.to(getattr(torch, spec.dtype))
    out = dict(compute_dtype=str(db.dtype).removeprefix("torch."),
               scale=None, rescore_db=None, rescore_bias=None)
    if spec.storage == "f32":
        rows, metric_bias = metric.prepare_database(db)
        bias = fuse_bias(metric_bias, live, num_rows=n, device=database.device)
        out.update(rows=rows, bias=bias, exact_rows=rows, exact_bias=bias)
        return out
    qr = metric.prepare_storage(db, spec.storage)
    bias = fuse_bias(qr.bias, live, num_rows=n, device=database.device)
    exact_bias = fuse_bias(qr.exact_bias, live, num_rows=n,
                           device=database.device)
    out.update(rows=qr.rows, bias=bias, scale=qr.scale,
               exact_rows=qr.exact_rows, exact_bias=exact_bias)
    if spec.rescore_enabled:
        out.update(rescore_db=qr.exact_rows.to(torch.float32),
                   rescore_bias=exact_bias)
    return out


def _layout_prepared(backend: str, prep: dict, n: int, d: int,
                     spec: SearchSpec) -> PackedState:
    return _layout(backend, prep["rows"], prep["bias"], n, d, spec,
                   scale=prep["scale"], rescore_db=prep["rescore_db"],
                   rescore_bias=prep["rescore_bias"],
                   compute_dtype=prep["compute_dtype"])


def pack_state(
    database: torch.Tensor,
    live: Optional[torch.Tensor],
    metric: Metric,
    spec: SearchSpec,
    backend: str,
    cluster_plan: Optional[clusterlib.ClusterPlan] = None,
    *,
    timings: Optional[dict] = None,
) -> PackedState:
    """Full pack: the cast to ``spec.dtype``, metric preparation (and, for
    a quantized tier, quantization with the bias of the stored values
    folded into the fused bias row, and the rescore tail) over all rows,
    then the layout.  An enabled ``cluster_plan`` builds the pruning side
    tables over the live prepared rows (:func:`_attach_cluster`);
    ``timings``, when given, receives the seconds of its steps."""
    n, d = database.shape
    prep = _prepare(database, live, metric, spec)
    PACK_EVENTS.inc("full_pack")
    state = _layout_prepared(backend, prep, n, d, spec)
    _attach_cluster(state, prep["exact_rows"], prep["exact_bias"], live,
                    metric, cluster_plan, spec.k, timings)
    return state


def pack_host_state(
    database: torch.Tensor,
    live: torch.Tensor,
    metric: Metric,
    spec: SearchSpec,
    backend: str,
    *,
    device,
    chunk_rows: int,
) -> PackedState:
    """Full pack of a host-resident index (``residency="host"``).

    ``database`` and ``live`` sit in host memory; their rows go to
    ``device`` ``chunk_rows`` at a time for :func:`pack_state`'s cast,
    preparation and quantization (row by row, so they equal a pack on
    that device), and come back to the host, where they are laid out in
    ``backend``'s layout.  No more than one chunk is ever on the device;
    a metric whose preparation couples rows takes one chunk.  No cluster
    tables: a host index never prunes."""
    n, d = database.shape
    chunk = chunk_rows if metric.rowwise else n
    parts = []
    for lo in range(0, n, chunk):
        prep = _prepare(database[lo : lo + chunk].to(device),
                        live[lo : lo + chunk].to(device), metric, spec)
        parts.append({key: v.cpu() if isinstance(v, torch.Tensor) else v
                      for key, v in prep.items()})
    prep = {key: (torch.cat([p[key] for p in parts])
                  if isinstance(parts[0][key], torch.Tensor)
                  else parts[0][key]) for key in parts[0]}
    PACK_EVENTS.inc("full_pack")
    return _layout_prepared(backend, prep, n, d, spec)


def pin_state(state: PackedState) -> PackedState:
    """Move a host state's operands into pinned (page-locked) host memory,
    the source a non-blocking copy to the card needs; raises where the
    build has no CUDA runtime to pin with."""
    for name in ("db", "bias", "scale", "rescore_db", "rescore_bias"):
        t = getattr(state, name)
        if t is not None and not t.is_pinned():
            setattr(state, name, t.cpu().pin_memory())
    return state


def _attach_cluster(state: PackedState, exact_rows: torch.Tensor,
                    fused_bias: torch.Tensor, live: Optional[torch.Tensor],
                    metric: Metric,
                    cluster_plan: Optional[clusterlib.ClusterPlan], k: int,
                    timings: Optional[dict] = None) -> None:
    """Build, check and attach the pruning side tables of an enabled plan.

    ``exact_rows`` are the full-precision prepared rows, ``fused_bias``
    their fused bias.  The planner's crossover prices FLOPs, not
    geometry, so the build measures the miss rate of its tables
    (``cluster.sampled_miss_rate``) and drops them past
    ``cluster.miss_check_threshold``: the layout then stays the dense one,
    the same as ``cluster="off"``.
    """
    if cluster_plan is None or not cluster_plan.enabled:
        return
    cs = clusterlib.build_tables(exact_rows, live, cluster_plan,
                                 metric.prepare_database, timings=timings)
    t0 = time.perf_counter()
    miss = clusterlib.sampled_miss_rate(cs, exact_rows, fused_bias, live, k)
    if timings is not None:
        timings["miss_check_s"] = time.perf_counter() - t0
        timings["sampled_miss"] = miss
    if miss > clusterlib.miss_check_threshold(cluster_plan.miss_budget):
        state.cluster_rejected_miss = miss
        PACK_EVENTS.inc("cluster_rejected")
        return
    state.cluster = cs
    PACK_EVENTS.inc("cluster_built")


def rebuild_cluster(state: PackedState, live: Optional[torch.Tensor],
                    metric: Metric,
                    cluster_plan: clusterlib.ClusterPlan) -> None:
    """The lazy recluster: new centroids and tables from the packed exact
    rows, no repack and no miss check (the data passed it at build)."""
    rows, _ = state.exact_rows_bias()
    state.cluster = clusterlib.build_tables(rows, live, cluster_plan,
                                            metric.prepare_database)
    PACK_EVENTS.inc("recluster")


# The reference's names of the two layouts: "xla" is the port's "torch"
# layout (rows, bias and scale unpadded), "pallas" the padded kernel layout.
REFERENCE_LAYOUT = {"torch": "xla", "cuda": "pallas", "sharded": "sharded"}


def snapshot_state(state: PackedState) -> Tuple[dict, dict]:
    """``(arrays, meta)`` of a PackedState for a snapshot, under the
    reference's names (``snapshot_state`` of ``src/repro/search/packed.py``)
    and in the layout the reference names there, so that either package
    restores it: the ``"torch"`` layout is the reference's ``"xla"`` one,
    and the ``"cuda"`` layout its ``"pallas"`` one, int4 re-padded to the
    reference's 256 lanes (the port's own is 128).  The bin plan is not
    stored: a restore re-plans it and checks the recorded ``bin_size``.
    A :class:`ShardedState` writes its full logical arrays under the
    reference's ``"sharded"`` layout (unpadded, one int4 code a byte)."""
    if isinstance(state, ShardedState):
        arrays = {"packed/db": state.rows(), "packed/bias": state.bias_row()}
        if state.scale_row() is not None:
            arrays["packed/scale"] = state.scale_row()
        rescore_db, rescore_bias = state.rescore_tail()
        if rescore_db is not None:
            arrays["packed/rescore_db"] = rescore_db
            arrays["packed/rescore_bias"] = rescore_bias
        return arrays, _snapshot_meta(state, arrays)
    db = state.db
    if state.int4_packed:
        codes = quant.unpack_int4_rows(db)
        db = quant.pack_int4_rows(
            F.pad(codes, (0, round_up(state.d, 256) - codes.shape[1])))
    arrays = {"packed/db": db, "packed/bias": state.bias}
    if state.scale is not None:
        arrays["packed/scale"] = state.scale
    if state.rescore_db is not None:
        arrays["packed/rescore_db"] = state.rescore_db
        arrays["packed/rescore_bias"] = state.rescore_bias
    return arrays, _snapshot_meta(state, arrays)


def _snapshot_meta(state, arrays: dict) -> dict:
    meta = {
        "backend": REFERENCE_LAYOUT[state.backend],
        "n": state.n,
        "d": state.d,
        "bin_size": state.bin_size,
        "block_n": state.block_n,
        "storage": state.storage,
        "compute_dtype": state.compute_dtype,
        "cluster_rejected_miss": state.cluster_rejected_miss,
        "cluster": None,
    }
    if state.cluster is not None:
        cl_arrays, cl_meta = clusterlib.snapshot_tables(state.cluster)
        arrays.update(cl_arrays)
        meta["cluster"] = cl_meta
    return meta


def _tensor(a, device) -> torch.Tensor:
    """An array of a snapshot (a tensor, or a numpy array; a numpy bf16 of
    the reference's extension type travels as its 16-bit pattern) as a
    tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def restore_state(arrays: dict, meta: dict, spec: SearchSpec,
                  device=None) -> PackedState:
    """The reference's name: :func:`state_from_arrays` on ``device``
    (default ``"cuda"``, as ``Index.build``)."""
    return state_from_arrays(arrays, meta, spec,
                             "cuda" if device is None else device)


def state_from_arrays(arrays: dict, meta: dict, spec: SearchSpec,
                      device) -> PackedState:
    """A PackedState from ``snapshot_state`` output (the reference's or
    the port's).

    ``arrays`` maps the snapshot's names to numpy arrays or tensors,
    ``meta`` is the snapshot's layout record.  The counterpart
    of the reference's ``restore_state``: no metric preparation, no
    quantization and no k-means — the saved stored rows (a pallas-layout
    int4 database unpacked to canonical codes), scale, fused bias, rescore
    tail and cluster tables (``cluster/*``, ``cluster.restore_tables``)
    are laid out for the port's backend on ``device`` — with the same
    checks:
    ``validate_restored``, and that ``plan_bins`` still gives the
    recorded bin size.  Either reference layout (xla or pallas) is
    accepted; ``spec.storage`` must be the snapshot's tier.
    """
    storage = meta["storage"]
    if storage != spec.storage:
        raise ValueError(
            f"snapshot storage={storage!r} but spec.storage={spec.storage!r}"
        )
    n, d = int(meta["n"]), int(meta["d"])
    plan = plan_bins(
        n, scan_k_for(spec, n), spec.recall_target,
        reduction_input_size_override=spec.reduction_input_size_override,
    )
    if plan.bin_size != meta["bin_size"]:
        raise ValueError(
            f"snapshot bin_size={meta['bin_size']} but this version plans "
            f"bin_size={plan.bin_size} for the same (n, k, target) — the "
            "binning math changed since the snapshot was written; rebuild "
            "the index"
        )
    device = torch.device(device)
    db = _tensor(arrays["packed/db"], device)
    scale = arrays.get("packed/scale")
    quant.validate_restored(storage, db.dtype, has_scale=scale is not None)
    want = getattr(torch, spec.dtype or "float32")
    if storage == "f32" and db.dtype != want:
        raise ValueError(f"packed/db is {db.dtype}, storage='f32' stores "
                         f"{want} rows for dtype={spec.dtype!r}")
    if storage == "int4" and meta["backend"] == "pallas":
        db = quant.unpack_int4_rows(db[:n])
    if db.shape[0] < n or db.shape[1] < d:
        raise ValueError(
            f"packed/db {tuple(db.shape)} does not hold {n} rows of {d}"
        )
    rows = db[:n, :d]
    bias = _tensor(arrays["packed/bias"], device).reshape(-1)[:n]
    if scale is not None:
        scale = _tensor(scale, device).reshape(-1)[:n]
    rescore_db = rescore_bias = None
    if "packed/rescore_db" in arrays:
        rescore_db = _tensor(arrays["packed/rescore_db"], device)[:n]
        rescore_bias = _tensor(arrays["packed/rescore_bias"], device).reshape(-1)[:n]
    if (rescore_db is not None) != spec.rescore_enabled:
        raise ValueError(
            f"snapshot {'has' if rescore_db is not None else 'lacks'} a "
            f"rescore tail but spec.rescore_enabled={spec.rescore_enabled}"
        )
    backend = spec.backend if spec.backend != "auto" else default_backend(device)
    compute_dtype = meta.get("compute_dtype", "float32")
    if storage == "f32" and db.dtype == torch.bfloat16:
        # the reference records float32 for an f32 tier of bf16 rows
        compute_dtype = "bfloat16"
    state = _layout(backend, rows, bias, n, d, spec, scale=scale,
                    rescore_db=rescore_db, rescore_bias=rescore_bias,
                    compute_dtype=compute_dtype)
    state.cluster_rejected_miss = meta.get("cluster_rejected_miss")
    if meta.get("cluster") is not None:
        state.cluster = clusterlib.restore_tables(arrays, meta["cluster"],
                                                  device)
    PACK_EVENTS.inc("restore")
    return state
