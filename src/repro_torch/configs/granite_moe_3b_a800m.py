"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) MoE 40e top-8.

Per-expert d_ff=512, vocab 49155.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    moe_d_ff=512,
    moe_group_size=2048,
))

SMOKE = register(ModelConfig(
    name="granite-moe-3b-a800m-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=64,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=32,
    moe_group_size=64,
    q_chunk=32,
))
