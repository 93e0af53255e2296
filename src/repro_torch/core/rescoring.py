"""ExactRescoring: exact top-k of the PartialReduce candidates.

Port of ``src/repro/core/rescoring.py``: the paper's bitonic network
(:func:`bitonic_sort_pairs`, the default of :func:`exact_rescoring`)
and a stable-sort fast path (``use_bitonic=False``).  The network keeps
the reference's compare-exchange rule, so among equal values (and for
±0.0 and NaN) it puts each pair where the reference's network does,
which is not where a stable sort puts it.  The reference's fast path is
``lax.top_k``, which puts the lower position first among equal values;
``torch.topk`` promises no order among ties, so the port sorts stably
instead.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["bitonic_sort_pairs", "exact_rescoring", "stable_topk"]


def stable_topk(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest ``k`` along the last axis, lower position first among ties
    (the order ``lax.top_k`` gives).  Returns (values, int64 positions)."""
    top, pos = torch.sort(values, dim=-1, descending=True, stable=True)
    return top[..., :k], pos[..., :k]


def _compare_exchange(vals, idxs, stage: int, substage: int, descending: bool):
    """One stage of the network: each lane against the lane ``2**substage``
    away, over the whole last axis at once."""
    d = 1 << substage
    lane = torch.arange(vals.shape[-1], device=vals.device)
    partner = lane ^ d
    v_p, i_p = vals[..., partner], idxs[..., partner]
    # Within blocks of 2**(stage+1) the order alternates, building bitonic
    # sequences; the last merge stage is monotone.
    block_desc = ((lane >> (stage + 1)) & 1) == 0
    if not descending:
        block_desc = ~block_desc
    is_lower = (lane & d) == 0
    # In a descending block the lower lane keeps the max.  A lane swaps
    # only on a strict comparison, so equal values (+0.0 and -0.0
    # included) and NaN stay put.
    keep_max = block_desc == is_lower
    swap = torch.where(keep_max, vals < v_p, vals > v_p)
    return torch.where(swap, v_p, vals), torch.where(swap, i_p, idxs)


def bitonic_sort_pairs(
    vals: torch.Tensor,
    idxs: torch.Tensor,
    *,
    descending: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bitonic sort of (vals, idxs) pairs along the last axis.

    The last axis is padded to the next power of two (at least 2) with
    -inf (descending) or +inf (ascending) and index 0, as the reference
    pads it.

    >>> v, i = bitonic_sort_pairs(torch.tensor([1.0, 3.0, 2.0]),
    ...                           torch.tensor([0, 1, 2]))
    >>> v.tolist(), i.tolist()
    ([3.0, 2.0, 1.0], [1, 2, 0])
    """
    n = vals.shape[-1]
    p = max(1, (n - 1).bit_length())
    padded = 1 << p
    if padded != n:
        fill = float("-inf") if descending else float("inf")
        pad_shape = vals.shape[:-1] + (padded - n,)
        vals = torch.cat([vals, vals.new_full(pad_shape, fill)], dim=-1)
        idxs = torch.cat([idxs, idxs.new_zeros(pad_shape)], dim=-1)
    for stage in range(p):
        for substage in range(stage, -1, -1):
            vals, idxs = _compare_exchange(vals, idxs, stage, substage, descending)
    return vals[..., :n], idxs[..., :n]


def exact_rescoring(
    vals: torch.Tensor,
    idxs: torch.Tensor,
    k: int,
    *,
    mode: str = "max",
    use_bitonic: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of (..., L) candidates, carrying their database indices.

    ``use_bitonic`` runs the paper's bitonic network (True, the
    reference's default) or a stable sort (False: ties to the lower
    position, the order of the reference's ``lax.top_k``).
    ``mode="min"`` ranks by ascending value.
    """
    if k > vals.shape[-1]:
        raise ValueError(f"k={k} exceeds candidate count L={vals.shape[-1]}")
    if mode not in ("max", "min"):
        raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
    sort_vals = vals if mode == "max" else -vals
    if use_bitonic:
        sv, si = bitonic_sort_pairs(sort_vals, idxs, descending=True)
        top_v, top_i = sv[..., :k], si[..., :k]
    else:
        top_v, pos = stable_topk(sort_vals, k)
        top_i = torch.gather(idxs, -1, pos)
    return (top_v if mode == "max" else -top_v), top_i
