"""Core algorithm of the port (``src/repro/core/``): bin planning,
PartialReduce, exact rescoring and approx top-k, in PyTorch."""
from repro_torch.core.binning import (
    BinPlan,
    bins_for_recall,
    bins_for_recall_approx,
    expected_recall,
    plan_bins,
    round_up,
)
from repro_torch.core.partial_reduce import (
    partial_reduce,
    partial_reduce_with_plan,
)
from repro_torch.core.rescoring import (
    bitonic_sort_pairs,
    exact_rescoring,
    stable_topk,
)
from repro_torch.core.topk import approx_max_k, approx_min_k

__all__ = [
    "BinPlan",
    "approx_max_k",
    "approx_min_k",
    "bitonic_sort_pairs",
    "bins_for_recall",
    "bins_for_recall_approx",
    "exact_rescoring",
    "expected_recall",
    "partial_reduce",
    "partial_reduce_with_plan",
    "plan_bins",
    "round_up",
    "stable_topk",
]
