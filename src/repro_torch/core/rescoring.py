"""ExactRescoring: exact top-k of the PartialReduce candidates.

Port of ``src/repro/core/rescoring.py`` (``exact_rescoring``).  The
reference's fast path is ``lax.top_k``, which puts the lower position
first among equal values.  ``torch.topk`` promises no order among ties,
so the port sorts stably instead.  The paper's bitonic network
(``use_bitonic=True``) is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["exact_rescoring", "stable_topk"]


def stable_topk(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest ``k`` along the last axis, lower position first among ties
    (the order ``lax.top_k`` gives).  Returns (values, int64 positions)."""
    top, pos = torch.sort(values, dim=-1, descending=True, stable=True)
    return top[..., :k], pos[..., :k]


def exact_rescoring(
    vals: torch.Tensor,
    idxs: torch.Tensor,
    k: int,
    *,
    mode: str = "max",
    use_bitonic: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of (..., L) candidates, carrying their database indices.

    ``mode="min"`` ranks by ascending value, ties again to the lower
    position.
    """
    if use_bitonic:
        raise NotImplementedError(
            "the bitonic rescoring network is not ported yet "
            "(ROADMAP queue A item 1); use use_bitonic=False"
        )
    if k > vals.shape[-1]:
        raise ValueError(f"k={k} exceeds candidate count L={vals.shape[-1]}")
    if mode not in ("max", "min"):
        raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
    top_v, pos = stable_topk(vals if mode == "max" else -vals, k)
    top_i = torch.gather(idxs, -1, pos)
    return (top_v if mode == "max" else -top_v), top_i
