"""stablelm-1.6b [dense]: 24L d_model=2048 32H (MHA kv=32) d_ff=5632 vocab=100352.

[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = register(ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
))

SMOKE = register(ModelConfig(
    name="stablelm-1.6b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    q_chunk=32,
))
