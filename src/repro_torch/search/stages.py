"""Search stages: score -> scan -> rescore -> merge -> finalize.

Port of the single-device stage primitives of
``src/repro/search/stages.py`` (``score_gathered`` and
``prune_candidates`` come with the cluster slice), over
metric-prepared operands in the internal max convention (maximize
``<q', x'> + bias``, negate once at the end).  On the cuda backend the
fused kernel (``repro_torch.kernels.partial_reduce.partial_reduce_fused``)
subsumes score + scan + ``merge_topk``; the two-pass composition is its
parity oracle (``SearchSpec(fused_select=False)``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.rescoring import exact_rescoring, stable_topk
from repro_torch.core.topk import approx_max_k

__all__ = [
    "MASK_VALUE",
    "finalize_values",
    "merge_topk",
    "pad_queries_to",
    "rescore_candidates",
    "scan_candidates",
    "score_rows",
    "sentinelize_masked",
]

# Finite -inf surrogate (float32 min): keeps the score paths free of NaN
# while still losing every comparison against real scores.
MASK_VALUE = float(np.finfo(np.float32).min)

Tensor = torch.Tensor


def sentinelize_masked(vals: Tensor, idxs: Tensor, n: int) -> Tensor:
    """Pair masked candidates (value <= MASK/2) with the sentinel index -1
    and clamp live winners into ``[0, n)``, so a masked winner can never
    alias row ``n - 1`` after ``merge_topk`` ties at MASK."""
    return torch.where(
        vals > MASK_VALUE * 0.5,
        torch.clamp(idxs, max=n - 1),
        torch.full_like(idxs, -1),
    )


def pad_queries_to(q: Tensor, width: int) -> Tensor:
    """Zero-pad query lanes up to a packed layout's d_pad (exact for dot
    products: the database's padded lanes are zero too)."""
    if q.shape[1] == width:
        return q
    return F.pad(q, (0, width - q.shape[1]))


def score_rows(q: Tensor, database: Tensor,
               row_bias: Optional[Tensor] = None,
               scale: Optional[Tensor] = None) -> Tensor:
    """Biased-MIPS score tile ``q @ db.T (* scale) + bias``.

    ``database`` holds the stored rows of any tier, widened to f32 for the
    product; ``scale`` is the int8/int4 per-row scale.  The bias comes
    after the scale (it is the bias of the stored values)."""
    scores = torch.einsum("ik,jk->ij", q, database.to(q.dtype))
    if scale is not None:
        scores = scores * scale[None, :]
    if row_bias is not None:
        scores = scores + row_bias[None, :]
    return scores


def scan_candidates(
    scores: Tensor,
    k: int,
    *,
    recall_target: float,
    reduction_input_size_override: int = -1,
    aggregate_to_topk: bool = True,
    use_bitonic: bool = False,
) -> Tuple[Tensor, Tensor]:
    """PartialReduce the score tile into L bin winners (or the top-k)."""
    return approx_max_k(
        scores,
        k,
        recall_target=recall_target,
        reduction_input_size_override=reduction_input_size_override,
        aggregate_to_topk=aggregate_to_topk,
        use_bitonic=use_bitonic,
    )


def rescore_candidates(q: Tensor, scan_vals: Tensor, idxs: Tensor,
                       rescore_db: Tensor, rescore_bias: Tensor, k: int,
                       k_scan: int, use_bitonic: bool = False
                       ) -> Tuple[Tensor, Tensor]:
    """Exact second pass of the quantized search (internal max convention).

    Cuts the candidates to the ``k_scan`` best by scan score, gathers
    their full-precision rows from the rescore tail, scores them exactly
    (``<q, x> + rescore_bias``), keeps masked what the scan masked, and
    returns the exact top-k.  An index of -1 wraps to the last row in the
    gather, as in the reference, and the mask then discards it.  Plain
    PyTorch: the reference computes this in XLA, outside any kernel.
    """
    if k_scan < scan_vals.shape[-1]:
        scan_vals, sel = stable_topk(scan_vals, k_scan)
        idxs = torch.gather(idxs, -1, sel)
    gather = idxs.long()
    rows = rescore_db[gather]                          # (m, k_scan, d)
    exact = torch.bmm(rows, q[:, :, None])[..., 0] + rescore_bias[gather]
    exact = torch.where(scan_vals > MASK_VALUE * 0.5, exact,
                        torch.full_like(exact, MASK_VALUE))
    return exact_rescoring(exact, idxs, k, mode="max", use_bitonic=use_bitonic)


def merge_topk(
    vals: Tensor,
    idxs: Tensor,
    k: int,
    *,
    extra_vals: Optional[Tensor] = None,
    extra_idxs: Optional[Tensor] = None,
    use_bitonic: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Exact top-k of one or two candidate streams (stable: among equal
    values the earlier position wins)."""
    if extra_vals is not None:
        vals = torch.cat([vals, extra_vals], dim=-1)
        idxs = torch.cat([idxs, extra_idxs], dim=-1)
    return exact_rescoring(vals, idxs, k, mode="max", use_bitonic=use_bitonic)


def finalize_values(vals: Tensor, negate_output: bool) -> Tensor:
    """The single internal-max -> public-value sign flip."""
    return -vals if negate_output else vals
