"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

Llama-arch code model.  [arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = register(ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    gated_mlp=False,
    act="gelu",
    fsdp_params=True,
))

SMOKE = register(ModelConfig(
    name="granite-20b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    gated_mlp=False,
    act="gelu",
    q_chunk=32,
))
