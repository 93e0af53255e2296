"""Serving-side cache utilities: sizing, layout, and cache growth planning.

Port of ``src/repro/serving/kvcache.py`` (pure arithmetic on a config).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

__all__ = ["cache_bytes_per_token", "plan_max_seq"]


def cache_bytes_per_token(cfg: ModelConfig, *, bytes_per_el: int = 2) -> int:
    """Per-token KV (or latent/state) cache footprint across all layers."""
    total = 0
    hd = cfg.resolved_head_dim
    for kind in cfg.layer_kinds():
        if kind == "ssm":
            continue  # O(1) state, no per-token growth
        if kind == "rglru":
            continue
        if kind == "local_attn":
            continue  # ring buffer: bounded by window, not seq
        if kind.startswith("mla"):
            total += (cfg.kv_lora_rank + cfg.qk_rope_dim) * bytes_per_el
        else:
            total += 2 * cfg.num_kv_heads * hd * bytes_per_el
    return total


def plan_max_seq(cfg: ModelConfig, batch: int, hbm_budget_bytes: float) -> int:
    """Longest cache that fits the HBM budget at this batch size."""
    per_tok = cache_bytes_per_token(cfg) * batch
    if per_tok == 0:
        return 1 << 30  # stateless growth (pure SSM/recurrent)
    return int(hbm_budget_bytes // per_tok)
