"""Plain PyTorch oracle for the bin-winner kernels.

Port of ``src/repro/kernels/ref.py``: same bias fusion and the same
lowest-index tie-break (``max`` along a dimension returns the first
maximal position), extended to the scaled storage tiers as the Pallas
kernels' ``_tile_winners`` computes them: ``(q @ x.T) * scale + bias``,
a product and then a sum, each rounded.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["partial_reduce_ref"]


def partial_reduce_ref(
    queries: torch.Tensor,
    database: torch.Tensor,
    bias: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    *,
    bin_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices), both (m, n // bin_size), for (m, d)
    queries, (n, d) f32 rows, a (1, n) bias and an optional (1, n)
    per-row scale."""
    m = queries.shape[0]
    n = database.shape[0]
    scores = torch.einsum("ik,jk->ij", queries, database)
    if scale is not None:
        scores = scores * scale
    scores = scores + bias
    num_bins = n // bin_size
    vals, args = scores.reshape(m, num_bins, bin_size).max(dim=-1)
    offsets = torch.arange(
        num_bins, dtype=torch.int32, device=scores.device
    ) * bin_size
    return vals, offsets[None, :] + args.to(torch.int32)
