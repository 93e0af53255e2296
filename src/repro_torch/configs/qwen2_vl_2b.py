"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

M-RoPE, dynamic resolution; the vision patch-embedding frontend is a STUB —
input_specs() provides precomputed patch embeddings.  [arXiv:2409.12191; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = register(ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mrope=True,
    input_mode="embeddings",
))

SMOKE = register(ModelConfig(
    name="qwen2-vl-2b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    mrope=True,
    input_mode="embeddings",
    q_chunk=32,
))
