"""Backends behind the search API.

Port of the f32 single-device paths of ``src/repro/search/backends.py``.
Both consume metric-prepared operands and an additive per-row bias, work
in the internal max convention and negate once for distance metrics:

  * :func:`dense_search` — the ``"torch"`` backend: the full score tile,
    then ``approx_max_k`` (the reference's ``"xla"`` path).
  * :func:`cuda_search_packed` — the ``"cuda"`` backend over packed
    operands (the reference's ``pallas_search_packed``): the fused
    scan→select kernel, or with ``fused_select=False`` the two-pass
    kernel, ``sentinelize_masked`` and ``merge_topk``.

``DISPATCH_COUNTS`` counts searches issued per backend by ``Index``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import partial_reduce as kernels
from repro_torch.search.metrics import get_metric
from repro_torch.search.stages import (
    finalize_values,
    merge_topk,
    scan_candidates,
    score_rows,
    sentinelize_masked,
)
from repro_torch.search.telemetry import AtomicCounter

__all__ = [
    "DISPATCH_COUNTS",
    "cuda_search_packed",
    "default_backend",
    "dense_search",
]

# backend name -> searches issued by Index (one per query block).
DISPATCH_COUNTS = AtomicCounter()


def default_backend(device) -> str:
    """Resolve backend="auto": the CUDA kernels for a CUDA device, the
    plain PyTorch path otherwise."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def dense_search(
    queries: torch.Tensor,
    database: torch.Tensor,
    row_bias: Optional[torch.Tensor] = None,
    *,
    metric: str = "mips",
    k: int = 10,
    recall_target: float = 0.95,
    reduction_input_size_override: int = -1,
    aggregate_to_topk: bool = True,
    use_bitonic: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain search: full (M, N) score tile + approx_max_k (paper
    Listings 1/2).  ``database`` is metric-prepared; ``row_bias`` carries
    the metric bias and tombstones."""
    m = get_metric(metric)
    q = m.prepare_queries(queries)
    scores = score_rows(q, database, row_bias)
    vals, idxs = scan_candidates(
        scores,
        k,
        recall_target=recall_target,
        reduction_input_size_override=reduction_input_size_override,
        aggregate_to_topk=aggregate_to_topk,
        use_bitonic=use_bitonic,
    )
    return finalize_values(vals, m.negate_output), idxs


def cuda_search_packed(
    queries: torch.Tensor,
    database: torch.Tensor,
    row_bias: torch.Tensor,
    *,
    metric: str,
    k: int,
    n: int,
    bin_size: int,
    aggregate_to_topk: bool = True,
    use_bitonic: bool = False,
    fused_select: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel search over packed operands (steady-state path).

    ``database`` (n_pad, d_pad) and ``row_bias`` (1, n_pad) satisfy the
    kernels' tiling contract (``repro_torch.search.packed``); ``n`` is
    the logical row space.  Masked result entries pair MASK_VALUE with the
    sentinel index -1 on both paths.
    """
    m_obj = get_metric(metric)
    q = m_obj.prepare_queries(queries)
    if fused_select and aggregate_to_topk:
        vals, idxs = kernels.partial_reduce_fused(
            q, database, row_bias, k_scan=k, bin_size=bin_size
        )
        return finalize_values(vals, m_obj.negate_output), idxs
    vals, idxs = kernels.partial_reduce_packed(
        q, database, row_bias, bin_size=bin_size
    )
    idxs = sentinelize_masked(vals, idxs, n)
    if aggregate_to_topk:
        vals, idxs = merge_topk(vals, idxs, k, use_bitonic=use_bitonic)
    return finalize_values(vals, m_obj.negate_output), idxs
