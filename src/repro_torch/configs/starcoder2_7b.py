"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.

GQA + RoPE.  [arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = register(ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    gated_mlp=False,
    act="gelu",
))

SMOKE = register(ModelConfig(
    name="starcoder2-7b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    gated_mlp=False,
    act="gelu",
    q_chunk=32,
))
