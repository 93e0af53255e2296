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
a time, the state kept in host memory, pinned by ``pin_state``).  Unlike the reference's immutable
arrays, ``update_rows`` and ``delete_rows`` write into the tensors in
place.  ``PACK_EVENTS`` counts each kind of work by name.
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
    "fuse_bias",
    "pack_host_state",
    "pack_state",
    "pin_state",
    "rebuild_cluster",
    "reset_pack_events",
    "restore_state",
    "scan_k_for",
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

    def relayout(self, backend: str, new_n: int, spec: SearchSpec) -> "PackedState":
        """Copy into a new capacity and/or backend, reusing prepared rows.

        The grown region is dead (bias ``MASK_VALUE``, scale 0) until
        ``update_rows`` writes it; the bin plan is re-derived for
        ``new_n``.  The cluster tables hold user row ids, which a relayout
        never renumbers: they are carried as they are.
        """
        rows, bias, scale = self.rows(), self.bias_row(), self.scale_row()
        rescore_db, rescore_bias = self.rescore_db, self.rescore_bias
        if new_n > self.n:
            grow = new_n - self.n
            rows = F.pad(rows, (0, 0, 0, grow))
            bias = F.pad(bias, (0, grow), value=MASK_VALUE)
            if scale is not None:
                scale = F.pad(scale, (0, grow))
            if rescore_db is not None:
                rescore_db = F.pad(rescore_db, (0, 0, 0, grow))
                rescore_bias = F.pad(rescore_bias, (0, grow), value=MASK_VALUE)
        PACK_EVENTS.inc("relayout")
        out = _layout(backend, rows, bias, new_n, self.d, spec, scale=scale,
                      rescore_db=rescore_db, rescore_bias=rescore_bias,
                      compute_dtype=self.compute_dtype)
        out.cluster = self.cluster
        return out


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
) -> PackedState:
    """Lay prepared (rows, bias, scale) out in the backend's shape (new
    tensors: the state never aliases the caller's rows).  The rescore tail
    keeps its gather layout on every backend."""
    plan = plan_bins(
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
REFERENCE_LAYOUT = {"torch": "xla", "cuda": "pallas"}


def snapshot_state(state: PackedState) -> Tuple[dict, dict]:
    """``(arrays, meta)`` of a PackedState for a snapshot, under the
    reference's names (``snapshot_state`` of ``src/repro/search/packed.py``)
    and in the layout the reference names there, so that either package
    restores it: the ``"torch"`` layout is the reference's ``"xla"`` one,
    and the ``"cuda"`` layout its ``"pallas"`` one, int4 re-padded to the
    reference's 256 lanes (the port's own is 128).  The bin plan is not
    stored: a restore re-plans it and checks the recorded ``bin_size``."""
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
    return arrays, meta


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
