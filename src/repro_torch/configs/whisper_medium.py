"""whisper-medium [audio]: 24+24L enc-dec d_model=1024 16H d_ff=4096 vocab=51865.

Conv audio frontend is a STUB — input_specs() provides precomputed frame
embeddings (B, 1500, d).  Sinusoidal positions (rope_theta=0).
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = register(ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_layers=24,
    encoder_seq=1500,
    input_mode="embeddings",
    rope_theta=0.0,
    gated_mlp=False,
    act="gelu",
))

SMOKE = register(ModelConfig(
    name="whisper-medium-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    is_encoder_decoder=True,
    encoder_layers=2,
    encoder_seq=48,
    input_mode="embeddings",
    rope_theta=0.0,
    gated_mlp=False,
    act="gelu",
    q_chunk=32,
))
