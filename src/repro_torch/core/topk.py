"""approx_max_k / approx_min_k: the paper's public operator.

Port of ``src/repro/core/topk.py``: PartialReduce over the bins that
``plan_bins`` derives from the recall target (Eq. 14), then exact
rescoring of the L bin winners.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.binning import plan_bins
from repro_torch.core.partial_reduce import partial_reduce_with_plan
from repro_torch.core.rescoring import exact_rescoring

__all__ = ["approx_max_k", "approx_min_k"]


def _approx_k(
    operand: torch.Tensor,
    k: int,
    *,
    mode: str,
    recall_target: float,
    reduction_input_size_override: int,
    aggregate_to_topk: bool,
    use_bitonic: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    plan = plan_bins(
        operand.shape[-1],
        k,
        recall_target,
        reduction_input_size_override=reduction_input_size_override,
    )
    vals, idxs = partial_reduce_with_plan(operand, plan, mode=mode)
    if not aggregate_to_topk:
        return vals, idxs
    return exact_rescoring(vals, idxs, k, mode=mode, use_bitonic=use_bitonic)


def approx_max_k(
    operand: torch.Tensor,
    k: int,
    *,
    recall_target: float = 0.95,
    reduction_input_size_override: int = -1,
    aggregate_to_topk: bool = True,
    use_bitonic: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k maxima along the last axis (paper Listing 1)."""
    return _approx_k(
        operand, k, mode="max", recall_target=recall_target,
        reduction_input_size_override=reduction_input_size_override,
        aggregate_to_topk=aggregate_to_topk, use_bitonic=use_bitonic,
    )


def approx_min_k(
    operand: torch.Tensor,
    k: int,
    *,
    recall_target: float = 0.95,
    reduction_input_size_override: int = -1,
    aggregate_to_topk: bool = True,
    use_bitonic: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k minima along the last axis (paper Listing 2)."""
    return _approx_k(
        operand, k, mode="min", recall_target=recall_target,
        reduction_input_size_override=reduction_input_size_override,
        aggregate_to_topk=aggregate_to_topk, use_bitonic=use_bitonic,
    )
