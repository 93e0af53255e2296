"""Architecture registry: importing this package registers all configs.

Port of ``src/repro/configs``: the ten architectures (FULL and SMOKE,
and the reference's optimized variants), field for field.  The paper's
kNN workloads (``knn_workloads``: ``KNNConfig``, ``KNN_WORKLOADS``) are
exported beside them and stay out of the model registry, as in the
reference.
"""
from repro_torch.configs import (  # noqa: F401
    deepseek_v2_236b,
    granite_20b,
    granite_moe_3b_a800m,
    internlm2_1_8b,
    knn_workloads,
    mamba2_2_7b,
    qwen2_vl_2b,
    recurrentgemma_9b,
    stablelm_1_6b,
    starcoder2_7b,
    whisper_medium,
)
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_configs,
    register,
)
from repro_torch.configs.knn_workloads import KNN_WORKLOADS, KNNConfig  # noqa: F401

ASSIGNED_ARCHS = (
    "deepseek-v2-236b",
    "granite-moe-3b-a800m",
    "granite-20b",
    "internlm2-1.8b",
    "starcoder2-7b",
    "stablelm-1.6b",
    "mamba2-2.7b",
    "qwen2-vl-2b",
    "whisper-medium",
    "recurrentgemma-9b",
)
