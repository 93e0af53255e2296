"""Config system: frozen model/run configs + the architecture registry.

Port of ``src/repro/configs/base.py``, field for field (pure data).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "register", "get_config", "list_configs", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | vlm | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    moe_group_size: int = 1024
    moe_capacity_factor: float = 1.5
    router_topk_impl: str = "exact"   # "exact" | "approx" (paper op)
    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # --- hybrid (recurrentgemma) ---
    block_pattern: Tuple[str, ...] = ()   # per-layer kinds; () -> uniform
    local_window: int = 0
    lru_width: int = 0
    lru_gate_blocks: int = 0   # 0 = dense gates; >0 = block-diagonal (Griffin)
    lru_scan_impl: str = "associative"   # "associative" | "linear" (chunked)
    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500           # whisper: 30s audio -> 1500 frames
    # --- modality frontend stub ---
    input_mode: str = "tokens"        # "tokens" | "embeddings" (stubbed frontend)
    # --- position / norm / act ---
    rope_theta: float = 10000.0
    mrope: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"
    gated_mlp: bool = True
    use_layer_norm: bool = False      # False -> RMSNorm
    tie_embeddings: bool = False
    # --- paper integration ---
    knn_attention_k: int = 128        # top-k keys for knn decode attention
    knn_recall_target: float = 0.95
    decode_sample_k: int = 40         # approx_max_k vocab sampling
    # --- numerics / partitioning ---
    dtype: str = "bfloat16"
    attn_scores_dtype: str = "float32"  # "bfloat16" halves score-tile traffic
    q_chunk: int = 512                # query-chunked attention block
    remat: str = "dots"               # "none" | "dots" | "full"
    train_microbatches: int = 1       # gradient accumulation chunks
    fsdp_params: bool = False         # shard params over DP axes too (>=20B)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a multiple of 128 so TP vocab-sharding divides."""
        return ((self.vocab_size + 127) // 128) * 128

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind list driving the scan-run grouping."""
        if self.block_pattern:
            reps = -(-self.num_layers // len(self.block_pattern))
            return (self.block_pattern * reps)[: self.num_layers]
        if self.is_encoder_decoder:
            return ("dec",) * self.num_layers
        if self.family == "ssm":
            return ("ssm",) * self.num_layers
        if self.num_experts:
            dense = ("mla_dense" if self.use_mla else "dense",) * self.first_k_dense
            moe = ("mla_moe" if self.use_mla else "moe",) * (
                self.num_layers - self.first_k_dense
            )
            return dense + moe
        kind = "mla_dense" if self.use_mla else "dense"
        return (kind,) * self.num_layers

    def param_count(self) -> int:
        """Approximate parameter count (for 6ND roofline accounting)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds():
            if kind == "ssm":
                di = self.ssm_expand * d
                nh = di // self.ssm_head_dim
                conv = di + 2 * self.ssm_state
                total += d * (2 * di + 2 * self.ssm_state + nh)
                total += 4 * conv + 3 * nh + di + di * d
                continue
            if kind == "rglru":
                lw = self.lru_width or d
                total += 2 * d * lw + 2 * lw * lw + lw * d + 7 * lw
                continue
            # attention part
            if kind.startswith("mla"):
                r = self.kv_lora_rank
                total += d * (r + self.qk_rope_dim)
                total += r * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                if self.q_lora_rank:
                    total += d * self.q_lora_rank + self.q_lora_rank * self.num_heads * (
                        self.qk_nope_dim + self.qk_rope_dim
                    )
                else:
                    total += d * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                total += self.num_heads * self.v_head_dim * d
            else:
                total += d * hd * (self.num_heads + 2 * self.num_kv_heads)
                total += self.num_heads * hd * d
            # ffn part
            if kind.endswith("moe"):
                total += d * self.num_experts
                total += self.num_experts * 3 * d * self.moe_d_ff
                total += self.num_shared_experts * 3 * d * self.moe_d_ff
            elif kind in ("dense", "mla_dense", "local_attn", "attn", "dec", "enc"):
                total += (3 if self.gated_mlp else 2) * d * self.d_ff
        if self.is_encoder_decoder:
            # encoder self-attn + ffn, decoder cross-attn (self+ffn counted above)
            enc = self.encoder_layers * (
                4 * d * self.num_heads * hd + (3 if self.gated_mlp else 2) * d * self.d_ff
            )
            cross = self.num_layers * 4 * d * self.num_heads * hd
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed-to experts count)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        inactive = (self.num_experts - self.experts_per_token) * 3 * d * self.moe_d_ff
        total -= inactive * (self.num_layers - self.first_k_dense)
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str   # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # Import side-effect registration.
        import repro_torch.configs  # noqa: F401

        if name not in _REGISTRY:
            raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
