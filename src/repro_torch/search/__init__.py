"""Public search API of the port (``src/repro/search/``): ``Index``,
``SearchSpec``, the metric registry, the packed state, the backends and
the planner.

>>> import torch
>>> from repro_torch.search import Index
>>> idx = Index.build(torch.eye(8), metric="l2", k=2, device="cpu")
>>> int(idx.search(torch.eye(8)[:1]).indices[0, 0])
0
"""
from repro_torch.search.backends import (
    DISPATCH_COUNTS,
    cuda_search_packed,
    cuda_search_packed_quant,
    default_backend,
    dense_search,
    dense_search_quant,
)
from repro_torch.search.index import Index, SearchResult
from repro_torch.search.metrics import (
    Metric,
    available_metrics,
    exact_cosine_nns,
    exact_l2nns,
    exact_mips,
    exact_search,
    get_metric,
    half_norms,
    l2_normalize,
    register_metric,
)
from repro_torch.search.packed import (
    PACK_EVENTS,
    PackedState,
    fuse_bias,
    pack_state,
    scan_k_for,
    state_from_arrays,
)
from repro_torch.search.plan import (
    Plan,
    PlanCache,
    detect_device,
    plan_buckets,
    plan_search,
    time_search,
    tune_plan,
)
from repro_torch.search.quant import (
    STORAGE_TIERS,
    QuantizedRows,
    check_metric_storage,
    dequantize_rows,
    is_quantized,
    pack_int4_rows,
    quantize_rows,
    scan_k,
    storage_bytes,
    storage_dtype,
    unpack_int4_rows,
    validate_restored,
)
from repro_torch.search.spec import BACKENDS, SearchSpec
from repro_torch.search.stages import (
    MASK_VALUE,
    finalize_values,
    merge_topk,
    pad_queries_to,
    rescore_candidates,
    scan_candidates,
    score_rows,
    sentinelize_masked,
)

__all__ = [
    "BACKENDS",
    "DISPATCH_COUNTS",
    "Index",
    "MASK_VALUE",
    "Metric",
    "PACK_EVENTS",
    "PackedState",
    "Plan",
    "PlanCache",
    "QuantizedRows",
    "STORAGE_TIERS",
    "SearchResult",
    "SearchSpec",
    "available_metrics",
    "check_metric_storage",
    "cuda_search_packed",
    "cuda_search_packed_quant",
    "default_backend",
    "detect_device",
    "dense_search",
    "dense_search_quant",
    "dequantize_rows",
    "exact_cosine_nns",
    "exact_l2nns",
    "exact_mips",
    "exact_search",
    "finalize_values",
    "fuse_bias",
    "get_metric",
    "half_norms",
    "is_quantized",
    "l2_normalize",
    "merge_topk",
    "pack_int4_rows",
    "pack_state",
    "pad_queries_to",
    "plan_buckets",
    "plan_search",
    "quantize_rows",
    "register_metric",
    "rescore_candidates",
    "scan_candidates",
    "scan_k",
    "scan_k_for",
    "score_rows",
    "sentinelize_masked",
    "state_from_arrays",
    "storage_bytes",
    "storage_dtype",
    "time_search",
    "tune_plan",
    "unpack_int4_rows",
    "validate_restored",
]
