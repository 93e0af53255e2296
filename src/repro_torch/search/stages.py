"""Search stages: score -> scan -> rescore -> merge -> finalize.

Port of the single-device stage primitives of
``src/repro/search/stages.py`` (with the cluster front-end's
``prune_candidates`` and ``score_gathered``), over
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
    "prune_candidates",
    "rescore_candidates",
    "scan_candidates",
    "score_gathered",
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
    product, and bf16 queries are widened too: each product is then exact
    and the sum is f32, as in the reference's jitted XLA program (its
    bf16 x bf16 einsum keeps the f32 sum, XLA's excess precision) and its
    Pallas kernels.  ``scale`` is the int8/int4 per-row scale.  The bias
    comes after the scale (it is the bias of the stored values)."""
    scores = torch.einsum("ik,jk->ij", q.to(torch.float32),
                          database.to(torch.float32))
    if scale is not None:
        scores = scores * scale[None, :]
    if row_bias is not None:
        scores = scores + row_bias[None, :]
    return scores


def score_gathered(q: Tensor, rows: Tensor, row_bias: Tensor, ids: Tensor,
                   valid: Tensor, scale: Optional[Tensor] = None) -> Tensor:
    """Biased-MIPS scores over per-query candidate rows: ``rows`` is the
    (m, S, d) gather ``database[ids]`` widened to f32, ``q`` (m, d) is
    widened too (a bf16 query times an f32 row is exact in f32, as in the
    reference's promotion); invalid slots (empty cluster tails) score
    ``MASK_VALUE``."""
    gather = ids.long()
    scores = torch.bmm(rows, q.to(rows.dtype)[:, :, None])[..., 0]
    if scale is not None:
        scores = scores * scale.reshape(-1)[gather]
    scores = scores + row_bias.reshape(-1)[gather]
    return torch.where(valid, scores, torch.full_like(scores, MASK_VALUE))


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
    # a bf16 query is widened: each product is exact in f32
    exact = (torch.bmm(rows, q.to(rows.dtype)[:, :, None])[..., 0]
             + rescore_bias[gather])
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


def prune_candidates(q: Tensor, centroids: Tensor, centroid_bias: Tensor,
                     cluster_rows: Tensor, spill_rows: Tensor, probes: int
                     ) -> Tuple[Tensor, Tensor]:
    """Per-query candidate row ids from the pruning side tables.

    Scores the prepared queries against the centroids (biased MIPS, the
    lowest cluster first among ties), keeps the top-``probes`` clusters
    and appends the spill block.  The slots INTERLEAVE the probed clusters
    (slot j of every cluster, then slot j + 1) so that a query's winners
    spread over the bins, as Eq. 13's collision bound assumes.  Returns
    ``(ids, valid)``: (m, S) user row ids clamped to >= 0, and the mask of
    real slots.
    """
    caff = q.to(centroids.dtype) @ centroids.T + centroid_bias[None, :]
    _, top_c = stable_topk(caff, probes)
    m = q.shape[0]
    slots = cluster_rows[top_c]                        # (m, probes, R)
    slots = slots.transpose(1, 2).reshape(m, -1)       # (m, R * probes)
    spill = spill_rows[None, :].expand(m, spill_rows.shape[0])
    ids = torch.cat([slots, spill], dim=1)             # (m, S)
    return torch.clamp(ids, min=0), ids >= 0


def finalize_values(vals: Tensor, negate_output: bool) -> Tensor:
    """The single internal-max -> public-value sign flip."""
    return -vals if negate_output else vals
