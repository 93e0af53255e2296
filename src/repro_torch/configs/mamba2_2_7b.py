"""mamba2-2.7b [ssm]: 64L d_model=2560 attn-free vocab=50280 ssm_state=128.

SSD (state-space duality).  [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,            # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
))

SMOKE = register(ModelConfig(
    name="mamba2-2.7b-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=1,
    num_kv_heads=1,
    head_dim=16,
    d_ff=0,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=16,
))
