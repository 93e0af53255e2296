"""Whisper's encoder-decoder and qwen2-vl's embeddings input with M-RoPE
against the reference.

Whisper: the sinusoidal positions (``rope_theta=0``), cross-attention
over an encoder KV, the ``enc`` stack with ``enc_final_norm``,
``params.from_reference`` unstacking the reference's ``encoder``, and
``make_prefill_step``'s (logits, caches, cross_kv) triple whose cross KV
the decode step takes.  qwen2-vl: prefill from patch embeddings (B, S,
d) and the full forward with explicit (3, S) M-RoPE streams.  Single
functions at f32 within 1e-5 relative (``assert_allclose`` with atol
1e-5); whole smoke models (prefill, then 12 replayed decode steps, exact
and kNN attention) at f32 within 1e-4 of the largest |logit| and at bf16
within 2^-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.models import transformer as ref_tfm
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from torch_lm_parity import (
    F32_REL,
    close,
    np32,
    pair,
    replay_equals_full_forward,
    replay_matches_reference,
    t,
)

WHISPER, QWEN = "whisper-medium-smoke", "qwen2-vl-2b-smoke"


@pytest.mark.parametrize("d", [64, 1024])
def test_sinusoid_matches_reference(d):
    """Angles up to 1499 rad (whisper's last frame): f32 holds such an
    angle to half its spacing (6.1e-5), so the two libraries' sin and cos
    agree to a few spacings of the largest angle."""
    pos = np.array([0, 1, 7, 1499], dtype=np.int32)
    np.testing.assert_allclose(tfm._sinusoid(t(pos), d).numpy(),
                               np32(ref_tfm._sinusoid(jnp.asarray(pos), d)),
                               rtol=0, atol=4 * float(np.spacing(np.float32(1499))))


@pytest.mark.parametrize("sq,q_chunk", [(1, 512), (40, 16)])
def test_cross_attention_matches_reference(sq, q_chunk):
    """A decode query and a chunked 40-token block over 48 encoder frames."""
    rng = np.random.default_rng(1)
    p = {k: rng.standard_normal(v.shape, dtype=np.float32) * 0.2
         for k, v in attn.cross_attn_defs(32, 4, 8).items()}
    enc = rng.standard_normal((2, 48, 32), dtype=np.float32)
    x = rng.standard_normal((2, sq, 32), dtype=np.float32)
    pt = {k: t(v) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    kv = attn.encode_cross_kv(pt, t(enc))
    rkv = ref_attn.encode_cross_kv(pj, jnp.asarray(enc))
    np.testing.assert_allclose(kv.k.numpy(), np32(rkv.k), rtol=1e-5, atol=1e-6)
    y = attn.cross_attention(pt, t(x), kv, num_heads=4, q_chunk=q_chunk)
    ry = ref_attn.cross_attention(pj, jnp.asarray(x), rkv, num_heads=4, q_chunk=q_chunk)
    np.testing.assert_allclose(y.numpy(), np32(ry), rtol=1e-5, atol=1e-5)


def test_whisper_state_dict_unstacks_the_encoder():
    cfg, _, model, ref_p = pair(WHISPER, "float32")
    assert len(model.encoder) == cfg.encoder_layers == 2
    np.testing.assert_array_equal(model.encoder[1].attn.wq.numpy(),
                                  np.asarray(ref_p["encoder"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(model.enc_final_norm.numpy(),
                                  np.asarray(ref_p["enc_final_norm"]))
    assert model.layers[0].cross.wk.shape == (64, 4, 16)


def test_whisper_encoder_matches_reference():
    cfg, rcfg, model, ref_p = pair(WHISPER, "float32")
    enc = np.random.default_rng(2).standard_normal((2, 48, 64), dtype=np.float32)
    out = tfm._encode(tfm._cast_params(model.params(), cfg), cfg, t(enc))
    ref = jax.jit(ref_tfm._encode, static_argnums=1)(ref_p, rcfg, jnp.asarray(enc))
    np.testing.assert_allclose(out.numpy(), np32(ref), rtol=1e-5, atol=1e-5)


def test_whisper_prefill_step_returns_cross_kv_for_decode():
    """The triple: one cross KV a decoder layer, over the encoder's frames,
    and a decode step that reads it (greedy tokens and logits)."""
    cfg, _, model, _ = pair(WHISPER, "float32")
    rng = np.random.default_rng(3)
    batch = {"tokens": t(rng.integers(0, 256, (2, 8)).astype(np.int32)),
             "enc_embeds": t(rng.standard_normal((2, 48, 64), dtype=np.float32))}
    logits, caches, cross = M.make_prefill_step(cfg)(model, batch)
    assert logits.shape == (2, 1, cfg.padded_vocab) and len(caches) == 2
    assert [tuple(kv.k.shape) for kv in cross] == [(2, 48, 4, 16)] * 2
    step = M.make_decode_step(cfg, sample="greedy")
    caches = tfm.init_caches(cfg, 2, 32, device="cpu")
    nxt, logits, caches = step(model, batch["tokens"][:, :1], caches, 0, None,
                               cross_kv=cross)
    assert nxt.shape == (2, 1) and torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="cross_kv"):
        tfm.forward_decode(model, batch["tokens"][:, :1], caches, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_smoke_matches_reference(dtype):
    replay_matches_reference(WHISPER, dtype)


def test_whisper_replay_equals_full_forward():
    replay_equals_full_forward(WHISPER)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen2_vl_smoke_matches_reference(dtype):
    """Prefill from (2, 40, 64) patch embeddings, decode from tokens."""
    replay_matches_reference(QWEN, dtype)


def test_qwen2_vl_mrope_positions_match_reference():
    """The full forward over patch embeddings with explicit (t, h, w)
    streams, and with the 1-D positions stacked (what prefill uses)."""
    cfg, rcfg, model, ref_p = pair(QWEN, "float32")
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((2, 40, 64), dtype=np.float32)
    pos3 = np.stack([np.arange(40) // 20, np.arange(40) % 20 // 5,
                     np.arange(40) % 5]).astype(np.int32)
    fwd = jax.jit(ref_tfm.forward_train, static_argnums=1)
    for mp in (pos3, None):
        ours = tfm.forward_train(model, t(emb), mrope_positions=None if mp is None
                                 else t(mp))
        ref = fwd(ref_p, rcfg, jnp.asarray(emb),
                  mrope_positions=None if mp is None else jnp.asarray(mp))
        close(ours, ref, F32_REL)
    plain = tfm.forward_train(model, t(emb))
    assert (ours - plain).abs().max() == 0
    assert (tfm.forward_train(model, t(emb), mrope_positions=t(pos3))
            - plain).abs().max() > 0


def test_qwen2_vl_replay_equals_full_forward():
    replay_equals_full_forward(QWEN)
