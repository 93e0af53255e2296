"""Plain PyTorch oracle for the bin-winner kernels.

Port of ``src/repro/kernels/ref.py``: same bias fusion and the same
lowest-index tie-break (``max`` along a dimension returns the first
maximal position).
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["partial_reduce_ref"]


def partial_reduce_ref(
    queries: torch.Tensor,
    database: torch.Tensor,
    bias: torch.Tensor,
    *,
    bin_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices), both (m, n // bin_size), for (m, d)
    queries, (n, d) rows and a (1, n) bias."""
    m = queries.shape[0]
    n = database.shape[0]
    scores = torch.einsum("ik,jk->ij", queries, database) + bias
    num_bins = n // bin_size
    vals, args = scores.reshape(m, num_bins, bin_size).max(dim=-1)
    offsets = torch.arange(
        num_bins, dtype=torch.int32, device=scores.device
    ) * bin_size
    return vals, offsets[None, :] + args.to(torch.int32)
