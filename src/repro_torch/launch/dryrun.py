"""The model-FLOP and ideal-memory counts of a cell.

Port of ``model_flops`` and ``ideal_memory_bytes`` of
``src/repro/launch/dryrun.py`` (arithmetic on a config and a shape).  The
rest of the reference's dry run (a cell lowered and costed without
running it) is ROADMAP queue A item 13b step 6.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["model_flops", "ideal_memory_bytes"]


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6 * N(_active) * tokens (+ attention KV term on decode)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens  # forward only
    # decode: one token/sequence + attention reads of the cache
    tokens = shape.global_batch
    attn = 0.0
    hd = cfg.resolved_head_dim
    for kind in cfg.layer_kinds():
        if kind in ("dense", "moe", "dec", "enc"):
            attn += 4.0 * cfg.num_heads * hd * shape.seq_len
        elif kind.startswith("mla"):
            attn += 4.0 * cfg.num_heads * cfg.kv_lora_rank * shape.seq_len
        elif kind == "local_attn":
            attn += 4.0 * cfg.num_heads * hd * min(cfg.local_window, shape.seq_len)
    return (2.0 * n + attn) * tokens


def ideal_memory_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Unavoidable global HBM traffic per step (roofline denominator).

    train:   read f32 params + m + v, write all three, plus one bf16
             read/write of activations at the layer boundaries.
    prefill: read bf16 params once + write the KV cache.
    decode:  read bf16 active params + read the whole cache once.
    """
    n = cfg.active_param_count()
    n_total = cfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        act = 2.0 * tokens * cfg.d_model * max(
            len(cfg.layer_kinds()), 1
        ) * 2  # save + reload once per layer boundary
        return 6.0 * 4.0 * n_total + act
    from repro_torch.serving.kvcache import cache_bytes_per_token

    cache = cache_bytes_per_token(cfg) * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_total + cache
    return 2.0 * n + cache
