"""PartialReduce over a score tensor (paper Alg. 1 / Alg. 2 semantics).

Port of ``src/repro/core/partial_reduce.py``.  Reduces an (..., N) score
tensor to the top-1 value and index of each of L contiguous bins of
2**W entries: bin(j) = j >> W.  Ties go to the lowest index (``max`` and
``min`` along a dimension return the first extremal position).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.binning import BinPlan, plan_bins

__all__ = ["partial_reduce", "partial_reduce_with_plan", "NEG_INF"]

NEG_INF = float("-inf")


def partial_reduce_with_plan(
    scores: torch.Tensor,
    plan: BinPlan,
    *,
    mode: str = "max",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bin-wise top-1 over the last axis of ``scores``.

    Returns ``(values, indices)``, both (..., L); indices are int32
    positions in the unpadded N axis.  Bins holding only padding return
    the +/-inf neutral with their index clamped to ``n - 1``.
    """
    if scores.shape[-1] != plan.n:
        raise ValueError(f"scores last dim {scores.shape[-1]} != plan.n {plan.n}")
    if mode not in ("max", "min"):
        raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
    neutral = NEG_INF if mode == "max" else -NEG_INF
    pad = plan.padded_n - plan.n
    if pad:
        scores = F.pad(scores, (0, pad), value=neutral)
    binned = scores.reshape(scores.shape[:-1] + (plan.num_bins, plan.bin_size))
    vals, args = binned.max(dim=-1) if mode == "max" else binned.min(dim=-1)
    offsets = torch.arange(
        plan.num_bins, dtype=torch.int32, device=scores.device
    ) * plan.bin_size
    idx = offsets + args.to(torch.int32)
    return vals, torch.clamp(idx, max=plan.n - 1)



def partial_reduce(
    scores: torch.Tensor,
    k: int,
    recall_target: float = 0.95,
    *,
    mode: str = "max",
    reduction_input_size_override: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plan the bins for (N, k, recall_target), then reduce
    (:func:`partial_reduce_with_plan`).

    >>> v, i = partial_reduce(torch.arange(8.0)[None], 1, 0.5)
    >>> tuple(v.shape), int(i[0, -1])
    ((1, 1), 7)
    """
    plan = plan_bins(
        scores.shape[-1],
        k,
        recall_target,
        reduction_input_size_override=reduction_input_size_override,
    )
    return partial_reduce_with_plan(scores, plan, mode=mode)
