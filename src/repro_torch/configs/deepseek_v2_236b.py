"""deepseek-v2-236b [moe]: 60L d_model=5120 128H (MLA) MoE 160e top-6.

MLA kv_lora=512, 2 shared + 160 routed experts top-6, per-expert d_ff=1536,
first layer dense.  [arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,       # MLA: logical heads; cache is the kv_lora latent
    head_dim=128,
    d_ff=12288,             # dense (first_k_dense) layers
    vocab_size=102400,
    num_experts=160,
    experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1536,
    first_k_dense=1,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    fsdp_params=True,
    moe_group_size=2048,
))

SMOKE = register(ModelConfig(
    name="deepseek-v2-236b-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    num_shared_experts=1,
    moe_d_ff=32,
    first_k_dense=1,
    use_mla=True,
    kv_lora_rank=32,
    q_lora_rank=48,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    moe_group_size=64,
    q_chunk=32,
))


# Optimized variant (the reference's TPU cell B): smaller MoE dispatch
# groups (dispatch einsum cost is linear in group size), tighter capacity,
# full remat + 8-way gradient accumulation so the cell fits HBM.
OPT = register(ModelConfig(
    **{**{f.name: getattr(FULL, f.name) for f in __import__("dataclasses").fields(FULL)},
       "name": "deepseek-v2-236b-opt", "moe_group_size": 512,
       "moe_capacity_factor": 1.25, "remat": "full", "train_microbatches": 8},
))
