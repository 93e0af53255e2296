"""Backends behind the search API.

Port of the single-device paths of ``src/repro/search/backends.py``.
All consume metric-prepared operands and an additive per-row bias, work
in the internal max convention and negate once for distance metrics:

  * :func:`dense_search` — the ``"torch"`` backend: the full score tile,
    then ``approx_max_k`` (the reference's ``"xla"`` path).
  * :func:`cuda_search_packed` — the ``"cuda"`` backend over packed
    operands (the reference's ``pallas_search_packed``): the fused
    scan→select kernel, or with ``fused_select=False`` the two-pass
    kernel, ``sentinelize_masked`` and ``merge_topk``.
  * :func:`dense_search_quant` and :func:`cuda_search_packed_quant` — the
    same two over any storage tier (``dense_search_quant`` and
    ``pallas_search_packed_quant``), and the one implementation of each
    (the f32 entry points above call them without a scale or a rescore
    tail): the scan over the stored rows keeps ``k_scan`` over-fetched
    candidates and ``rescore_candidates`` re-scores them exactly against
    the rescore tail; without a tail the scan's own scores are returned.

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
    rescore_candidates,
    scan_candidates,
    score_rows,
    sentinelize_masked,
)
from repro_torch.search.telemetry import AtomicCounter

__all__ = [
    "DISPATCH_COUNTS",
    "cuda_search_packed",
    "cuda_search_packed_quant",
    "default_backend",
    "dense_search",
    "dense_search_quant",
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
    the metric bias and tombstones.  :func:`dense_search_quant` without a
    scale or a rescore tail."""
    return dense_search_quant(
        queries, database, row_bias, None, None, None, metric=metric, k=k,
        k_scan=k, recall_target=recall_target,
        reduction_input_size_override=reduction_input_size_override,
        aggregate_to_topk=aggregate_to_topk, use_bitonic=use_bitonic,
    )


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
    """Kernel search over packed f32 operands (steady-state path).

    ``database`` (n_pad, d_pad) and ``row_bias`` (1, n_pad) satisfy the
    kernels' tiling contract (``repro_torch.search.packed``); ``n`` is
    the logical row space.  Masked result entries pair MASK_VALUE with the
    sentinel index -1 on both paths.  :func:`cuda_search_packed_quant`
    without a scale or a rescore tail.
    """
    return cuda_search_packed_quant(
        queries, database, row_bias, None, None, None, metric=metric, k=k,
        k_scan=k, n=n, bin_size=bin_size, aggregate_to_topk=aggregate_to_topk,
        use_bitonic=use_bitonic, fused_select=fused_select,
    )


def dense_search_quant(
    queries: torch.Tensor,
    database: torch.Tensor,
    row_bias: Optional[torch.Tensor],
    scale: Optional[torch.Tensor],
    rescore_db: Optional[torch.Tensor],
    rescore_bias: Optional[torch.Tensor],
    *,
    metric: str,
    k: int,
    k_scan: int,
    recall_target: float = 0.95,
    reduction_input_size_override: int = -1,
    aggregate_to_topk: bool = True,
    use_bitonic: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain search over any tier: the score tile of the stored rows
    (``* scale`` for int8/int4, ``+ row_bias``, the bias of the stored
    values), then with a rescore tail the bins planned for ``k_scan`` and
    the exact rescore; without one, the scan's top-k."""
    m = get_metric(metric)
    q = m.prepare_queries(queries)
    scores = score_rows(q, database, row_bias, scale)
    if rescore_db is not None:
        vals, idxs = scan_candidates(
            scores, k_scan, recall_target=recall_target,
            reduction_input_size_override=reduction_input_size_override,
            aggregate_to_topk=False,
        )
        vals, idxs = rescore_candidates(
            q, vals, idxs, rescore_db, rescore_bias, k, k_scan, use_bitonic
        )
    else:
        vals, idxs = scan_candidates(
            scores, k, recall_target=recall_target,
            reduction_input_size_override=reduction_input_size_override,
            aggregate_to_topk=aggregate_to_topk, use_bitonic=use_bitonic,
        )
    return finalize_values(vals, m.negate_output), idxs


def cuda_search_packed_quant(
    queries: torch.Tensor,
    database: torch.Tensor,
    row_bias: torch.Tensor,
    scale: Optional[torch.Tensor],
    rescore_db: Optional[torch.Tensor],
    rescore_bias: Optional[torch.Tensor],
    *,
    metric: str,
    k: int,
    k_scan: int,
    n: int,
    bin_size: int,
    aggregate_to_topk: bool = True,
    use_bitonic: bool = False,
    fused_select: bool = False,
    int4_packed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel search over packed operands of any tier.

    The kernels stream the stored rows (``int4_packed``: nibble pairs of
    stored width d_pad / 2) and apply ``scale``; the over-fetched winners
    are then re-scored exactly against ``rescore_db``/``rescore_bias``.
    The branches are the reference's: fused with rescore (the kernel's
    top-``k_scan`` feeds the rescore), fused without rescore (top-``k``),
    and two-pass with ``sentinelize_masked``, then rescore or
    ``merge_topk``.
    """
    m_obj = get_metric(metric)
    q = m_obj.prepare_queries(queries)
    if fused_select and (rescore_db is not None or aggregate_to_topk):
        vals, idxs = kernels.partial_reduce_fused(
            q, database, row_bias, scale,
            k_scan=k_scan if rescore_db is not None else k,
            bin_size=bin_size, int4_packed=int4_packed,
        )
        if rescore_db is not None:
            vals, idxs = rescore_candidates(
                q, vals, idxs, rescore_db, rescore_bias, k, k_scan, use_bitonic
            )
        return finalize_values(vals, m_obj.negate_output), idxs
    vals, idxs = kernels.partial_reduce_packed(
        q, database, row_bias, scale, bin_size=bin_size,
        int4_packed=int4_packed,
    )
    idxs = sentinelize_masked(vals, idxs, n)
    if rescore_db is not None:
        vals, idxs = rescore_candidates(
            q, vals, idxs, rescore_db, rescore_bias, k, k_scan, use_bitonic
        )
    elif aggregate_to_topk:
        vals, idxs = merge_topk(vals, idxs, k, use_bitonic=use_bitonic)
    return finalize_values(vals, m_obj.negate_output), idxs
