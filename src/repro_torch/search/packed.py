"""PackedState: device-resident, backend-layout search operands (f32 tier).

Port of ``src/repro/search/packed.py``.  At build and mutation time
(never at search time) it holds

  * the metric-prepared database in the backend's layout — for
    ``"cuda"`` padded to the kernels' tiling contract: D to a multiple of
    128, N to a multiple of ``block_n = max(bin_size, BLOCK_N)``;
  * the fused bias row — metric bias, tombstones and tail mask in one
    additive term;
  * the bin plan the layout was derived from.

Mutations, as in the reference: ``update_rows`` prepares only an appended
slice, ``delete_rows`` patches only bias entries, ``relayout`` copies into
a new capacity without re-preparing rows, and ``pack_state`` is the only
full pack.  Unlike the reference's immutable arrays, ``update_rows`` and
``delete_rows`` write into the tensors in place.  ``PACK_EVENTS`` counts
each kind of work by name.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.binning import BinPlan, plan_bins, round_up
from repro_torch.kernels import partial_reduce as kernels
from repro_torch.search.backends import default_backend
from repro_torch.search.metrics import Metric
from repro_torch.search.spec import SearchSpec
from repro_torch.search.stages import MASK_VALUE
from repro_torch.search.telemetry import AtomicCounter

__all__ = [
    "PACK_EVENTS",
    "PackedState",
    "fuse_bias",
    "pack_state",
    "scan_k_for",
    "state_from_arrays",
]

# event name -> packing work performed ("full_pack", "relayout",
# "rows_updated", "bias_patched", "restore").
PACK_EVENTS = AtomicCounter()


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
      db: metric-prepared database; (n, d) for "torch", padded
        (n_pad, d_pad) for "cuda".
      bias: fused bias row; (n,) for "torch", (1, n_pad) for "cuda" with
        the tail pre-masked to ``MASK_VALUE``.
      n: logical row space (== Index.capacity).
      d: logical feature dim (before lane padding).
      plan: the BinPlan of the layout.
      bin_size / block_n: kernel layout constants (block_n == 0 for
        "torch").
    """

    backend: str
    db: torch.Tensor
    bias: torch.Tensor
    n: int
    d: int
    plan: BinPlan
    bin_size: int
    block_n: int

    def rows(self) -> torch.Tensor:
        """The prepared rows without layout padding: (n, d)."""
        return self.db[: self.n, : self.d]

    def bias_row(self) -> torch.Tensor:
        """The fused bias without layout padding: (n,)."""
        flat = self.bias[0] if self.bias.ndim == 2 else self.bias
        return flat[: self.n]

    def operands(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The positional operands a search consumes: ``(db, bias)``."""
        return self.db, self.bias

    def update_rows(self, start: int, rows: torch.Tensor, metric: Metric):
        """Prepare and write an appended row slice in place, O(r·D)."""
        prepped, metric_bias = metric.prepare_update(rows.to(self.db.dtype))
        r = prepped.shape[0]
        self.db[start : start + r] = F.pad(
            prepped, (0, self.db.shape[1] - prepped.shape[1])
        )
        self.bias_row()[start : start + r] = fuse_bias(
            metric_bias, num_rows=r, device=self.db.device
        )
        PACK_EVENTS.inc("rows_updated")

    def delete_rows(self, ids: torch.Tensor):
        """Tombstone rows: set their bias entries to ``MASK_VALUE``."""
        self.bias_row()[ids] = MASK_VALUE
        PACK_EVENTS.inc("bias_patched")

    def relayout(self, backend: str, new_n: int, spec: SearchSpec) -> "PackedState":
        """Copy into a new capacity and/or backend, reusing prepared rows.

        The grown region is dead (bias ``MASK_VALUE``) until
        ``update_rows`` writes it; the bin plan is re-derived for
        ``new_n``.
        """
        rows, bias = self.rows(), self.bias_row()
        if new_n > self.n:
            grow = new_n - self.n
            rows = F.pad(rows, (0, 0, 0, grow))
            bias = F.pad(bias, (0, grow), value=MASK_VALUE)
        PACK_EVENTS.inc("relayout")
        return _layout(backend, rows, bias, new_n, self.d, spec)


def scan_k_for(spec: SearchSpec, n: int) -> int:
    """The k the scan's bin layout is planned for: the user's k on the f32
    tier (the quantized over-fetch comes with the storage tiers)."""
    return spec.k


def _layout(
    backend: str,
    rows: torch.Tensor,
    bias: torch.Tensor,
    n: int,
    d: int,
    spec: SearchSpec,
) -> PackedState:
    """Lay prepared (rows, bias) out in the backend's shape (new tensors:
    the state never aliases the caller's rows)."""
    plan = plan_bins(
        n, scan_k_for(spec, n), spec.recall_target,
        reduction_input_size_override=spec.reduction_input_size_override,
    )
    bin_size = plan.bin_size
    if backend == "cuda":
        block_n = max(bin_size, kernels.BLOCK_N)
        n_pad = round_up(max(n, block_n), block_n)
        d_pad = round_up(d, 128)
        db = F.pad(rows, (0, d_pad - d, 0, n_pad - n))
        full = F.pad(bias.to(torch.float32), (0, n_pad - n), value=MASK_VALUE)
        return PackedState(
            backend=backend, db=db, bias=full[None, :].contiguous(), n=n,
            d=d, plan=plan, bin_size=bin_size, block_n=block_n,
        )
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    return PackedState(
        backend=backend, db=rows.clone(), bias=bias.to(torch.float32).clone(),
        n=n, d=d, plan=plan, bin_size=bin_size, block_n=0,
    )


def pack_state(
    database: torch.Tensor,
    live: Optional[torch.Tensor],
    metric: Metric,
    spec: SearchSpec,
    backend: str,
) -> PackedState:
    """Full pack: metric preparation over all rows, then the layout."""
    n, d = database.shape
    db, metric_bias = metric.prepare_database(database)
    bias = fuse_bias(metric_bias, live, num_rows=n, device=database.device)
    PACK_EVENTS.inc("full_pack")
    return _layout(backend, db, bias, n, d, spec)


def state_from_arrays(arrays: dict, meta: dict, spec: SearchSpec,
                      device) -> PackedState:
    """A PackedState from the reference's ``snapshot_state`` output.

    ``arrays`` maps the snapshot's names to numpy arrays (the caller
    converts), ``meta`` is the snapshot's layout record.  The counterpart
    of the reference's ``restore_state``: no metric preparation — the
    saved prepared rows and fused bias are laid out for the port's
    backend on ``device`` — and the same check that ``plan_bins`` still
    gives the recorded bin size.  Either reference layout (xla or
    pallas) is accepted.
    """
    if meta["storage"] != "f32":
        raise NotImplementedError(
            f"storage={meta['storage']!r}: quantized tiers are not ported yet "
            "(ROADMAP queue A item 6)"
        )
    if meta.get("cluster") is not None:
        raise NotImplementedError(
            "cluster side tables are not ported yet (ROADMAP queue A item 7)"
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
    db = np.asarray(arrays["packed/db"])
    bias = np.asarray(arrays["packed/bias"]).reshape(-1)
    if db.dtype != np.float32 or db.shape[0] < n or db.shape[1] < d:
        raise ValueError(
            f"packed/db {db.dtype}{db.shape} does not hold {n} f32 rows of {d}"
        )
    device = torch.device(device)
    rows = torch.tensor(db[:n, :d], device=device)
    bias_t = torch.tensor(bias[:n], device=device)
    backend = spec.backend if spec.backend != "auto" else default_backend(device)
    PACK_EVENTS.inc("restore")
    return _layout(backend, rows, bias_t, n, d, spec)
