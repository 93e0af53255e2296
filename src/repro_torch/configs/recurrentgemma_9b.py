"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288.

RG-LRU + local attention, pattern (recurrent, recurrent, local_attn);
window 2048, lru_width 4096, vocab 256000.  [arXiv:2402.19427; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=2048,
    lru_width=4096,
    act="gelu",
    fsdp_params=True,
))

SMOKE = register(ModelConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=16,
    lru_width=64,
    act="gelu",
    q_chunk=32,
))


# Optimized variant (the reference's TPU cell A): block-diagonal RG-LRU
# gates (the Griffin paper's own design) remove one f32 (B,S,lru) all-reduce
# per gate per layer under tensor parallelism.
OPT = register(ModelConfig(
    **{**{f.name: getattr(FULL, f.name) for f in __import__("dataclasses").fields(FULL)},
       "name": "recurrentgemma-9b-opt", "lru_gate_blocks": 16},
))
