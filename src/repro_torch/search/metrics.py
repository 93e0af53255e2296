"""Metric registry: the single owner of score transforms and sign conventions.

Port of ``src/repro/search/metrics.py``.  Every backend reduces every
metric to one internal problem: *maximize* ``<q', x'> + bias(x')`` over
metric-prepared queries ``q'`` and rows ``x'``, negating once at the API
boundary for distance metrics.  Value contract:

  * ``mips``:   inner products ``<q, x>``; descending.
  * ``cosine``: cosine similarities; descending.
  * ``l2``:     relaxed distances ``||x||^2/2 - <q, x>`` (Eq. 19);
                ascending.

>>> get_metric("l2").negate_output
True
>>> "cosine" in available_metrics()
True
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.rescoring import stable_topk
from repro_torch.search import quant

__all__ = [
    "Metric",
    "register_metric",
    "get_metric",
    "available_metrics",
    "half_norms",
    "l2_normalize",
    "exact_mips",
    "exact_l2nns",
    "exact_cosine_nns",
    "exact_search",
]

Tensor = torch.Tensor


def half_norms(database: Tensor) -> Tensor:
    """Precomputed ``||x||^2 / 2`` per database row (Eq. 19).

    bf16 rows round as XLA's CPU code rounds the reference's
    ``0.5 * sum(square(x))``: each square to bf16, the sum in f32, the
    sum to bf16 (bit-equal to it on the tests' data)."""
    if database.dtype == torch.bfloat16:
        squares = (database * database).to(torch.float32)
        return 0.5 * torch.sum(squares, dim=-1).to(torch.bfloat16)
    return 0.5 * torch.sum(database * database, dim=-1)


def l2_normalize(x: Tensor, eps: float = 1e-12) -> Tensor:
    """``x / max(||x||, eps)`` per row.  bf16 rows round as XLA's CPU code
    rounds the reference's ``jnp.linalg.norm``: the squares and their sum
    in f32, the sum to bf16, its square root to bf16, the quotient to
    bf16 (bit-equal to it on the tests' data)."""
    if x.dtype == torch.bfloat16:
        wide = x.to(torch.float32)
        sq = torch.sum(wide * wide, dim=-1, keepdim=True).to(torch.bfloat16)
        norm = torch.sqrt(sq.to(torch.float32)).to(torch.bfloat16)
        return (wide / torch.clamp(norm.to(torch.float32), min=eps)).to(
            torch.bfloat16)
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=eps)


@dataclasses.dataclass(frozen=True)
class Metric:
    """One similarity/distance mode, reduced to biased-MIPS form.

    Attributes:
      name: registry key.
      negate_output: True when public values are ascending distances.
      prepare_database: db -> (db', row_bias or None), once per build.
      prepare_queries: q -> q' on every search.
      exact: (q, db_raw, k) -> (values, int32 indices), the exact
        baseline under the same value contract.
      rowwise: ``prepare_database`` is a per-row map, so ``Index.add``
        may prepare only the appended slice.
      storage_tiers: the ``quant`` storage tiers this metric's prepared
        rows survive (all built-ins support every tier).
    """

    name: str
    negate_output: bool
    prepare_database: Callable[[Tensor], Tuple[Tensor, Optional[Tensor]]]
    prepare_queries: Callable[[Tensor], Tensor]
    exact: Callable[[Tensor, Tensor, int], Tuple[Tensor, Tensor]]
    rowwise: bool = True
    storage_tiers: Tuple[str, ...] = quant.STORAGE_TIERS

    def _check_rowwise(self) -> None:
        if not self.rowwise:
            raise ValueError(
                f"metric {self.name!r} is not row-wise; incremental "
                "preparation is undefined — repack the full database"
            )

    def prepare_update(self, rows: Tensor) -> Tuple[Tensor, Optional[Tensor]]:
        """Incremental preparation of an appended row slice (row-wise
        metrics only; others need a full repack)."""
        self._check_rowwise()
        return self.prepare_database(rows)

    # -- quantize-aware packing (the quant storage tiers) --------------------

    def storage_bias(self, stored: Tensor, scale: Optional[Tensor],
                     storage: str) -> Optional[Tensor]:
        """Metric bias of the values a quantized tier stores: the scan
        ranks by ``<q, x_hat> + bias`` with ``x_hat`` the dequantized row,
        so the bias comes from ``prepare_database`` on ``x_hat``."""
        quant.check_metric_storage(self, storage)
        _, bias = self.prepare_database(quant.dequantize_rows(stored, scale))
        return bias

    def prepare_storage(self, rows: Tensor, storage: str) -> quant.QuantizedRows:
        """Metric-prepare and tier-quantize ``rows``: the stored rows,
        their scale, the bias of the stored values, and the full-precision
        rescore tail.  For ``"f32"`` the stored and exact views alias."""
        quant.check_metric_storage(self, storage)
        prepped, bias = self.prepare_database(rows)
        if not quant.is_quantized(storage):
            return quant.QuantizedRows(prepped, None, bias, prepped, bias)
        stored, scale = quant.quantize_rows(prepped, storage)
        return quant.QuantizedRows(
            stored, scale, self.storage_bias(stored, scale, storage),
            prepped, bias,
        )

    def prepare_update_storage(self, rows: Tensor,
                               storage: str) -> quant.QuantizedRows:
        """Incremental :meth:`prepare_storage` of an appended row slice;
        quantization is per row, so slice and full packs agree exactly."""
        self._check_rowwise()
        return self.prepare_storage(rows, storage)


_REGISTRY: Dict[str, Metric] = {}


def register_metric(metric: Metric, *, overwrite: bool = False) -> Metric:
    if metric.name in _REGISTRY and not overwrite:
        raise ValueError(f"metric {metric.name!r} already registered")
    _REGISTRY[metric.name] = metric
    return metric


def get_metric(metric) -> Metric:
    if isinstance(metric, Metric):
        return metric
    try:
        return _REGISTRY[metric]
    except KeyError:
        raise ValueError(
            f"unknown metric {metric!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def available_metrics() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# --- Exact baselines (recall evaluation / Faiss-Flat analogue) --------------


def _topk(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    vals, idxs = stable_topk(scores, k)
    return vals, idxs.to(torch.int32)


def exact_mips(queries: Tensor, database: Tensor, k: int = 10):
    return _topk(torch.einsum("ik,jk->ij", queries, database), k)


def exact_l2nns(queries: Tensor, database: Tensor, k: int = 10):
    dists = half_norms(database)[None, :] - torch.einsum(
        "ik,jk->ij", queries, database
    )
    vals, idxs = _topk(-dists, k)
    return -vals, idxs


def exact_cosine_nns(queries: Tensor, database: Tensor, k: int = 10):
    scores = torch.einsum(
        "ik,jk->ij", l2_normalize(queries), l2_normalize(database)
    )
    return _topk(scores, k)


def exact_search(queries: Tensor, database: Tensor, k: int = 10, *,
                 metric="mips"):
    """Exact top-k under any registered metric (same value contract)."""
    return get_metric(metric).exact(queries, database, k)


# --- Built-in metrics -------------------------------------------------------

register_metric(
    Metric(
        name="mips",
        negate_output=False,
        prepare_database=lambda db: (db, None),
        prepare_queries=lambda q: q,
        exact=exact_mips,
    )
)

register_metric(
    Metric(
        name="l2",
        negate_output=True,
        # bias = -||x||^2/2: maximizing <q,x> + bias == minimizing the
        # relaxed distance (Eq. 19, one COP folded into the bias row).
        prepare_database=lambda db: (db, -half_norms(db)),
        prepare_queries=lambda q: q,
        exact=exact_l2nns,
    )
)

register_metric(
    Metric(
        name="cosine",
        negate_output=False,
        prepare_database=lambda db: (l2_normalize(db), None),
        prepare_queries=l2_normalize,
        exact=exact_cosine_nns,
    )
)
