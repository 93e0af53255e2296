"""MLA (``attention.mla_*``) and the ``mla_dense``/``mla_moe`` kinds
against the reference.

The layer functions take the reference's seeded numpy inputs and
parameters, with and without a query LoRA; f32 within 1e-5 relative
(``assert_allclose`` with atol 1e-5, as the dense attention's tests).
The absorbed-matmul decode writes its latent rows in place and matches
the reference with exact and kNN attention (early in a decode, when
most selected positions are masked, and late); its kNN branch gathers
each (batch, head)'s selected latent rows where the reference widens
the cache to H heads first.  deepseek-v2-236b-smoke (one ``mla_dense``
and two ``mla_moe`` layers) runs whole through ``params.from_reference``
(f32 within 1e-4 of the largest |logit|, bf16 within 2^-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import attention as ref_attn
from repro_torch.models import attention as attn
from torch_lm_parity import (
    np32,
    replay_equals_full_forward,
    replay_matches_reference,
    t,
)

NAME = "deepseek-v2-236b-smoke"
DIMS = dict(kv_lora_rank=24, qk_nope_dim=16, qk_rope_dim=8)


def _case(seed, q_lora, *, d=32, heads=4, b=2, s=96):
    rng = np.random.default_rng(seed)
    defs = attn.mla_defs(d, heads, q_lora_rank=q_lora, v_head_dim=12, **DIMS)
    p = {k: rng.standard_normal(v.shape, dtype=np.float32) * 0.2
         for k, v in defs.items()}
    x = rng.standard_normal((b, s, d), dtype=np.float32)
    return p, x


def _both(p):
    return ({k: t(v) for k, v in p.items()}, {k: jnp.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("q_lora", [0, 20])
def test_mla_defs_match_reference(q_lora):
    ours = attn.mla_defs(32, 4, q_lora_rank=q_lora, v_head_dim=12, **DIMS)
    ref = ref_attn.mla_defs(32, 4, q_lora_rank=q_lora, v_head_dim=12, **DIMS)
    assert {k: (v.shape, v.axes, v.init) for k, v in ours.items()} == \
        {k: (v.shape, v.axes, v.init) for k, v in ref.items()}


@pytest.mark.parametrize("q_chunk", [512, 32])
@pytest.mark.parametrize("q_lora", [0, 20])
def test_mla_train_matches_reference(q_lora, q_chunk):
    """Prefill over 96 positions (one query block, or three of 32): the
    value head dim (12) differs from the query's (24)."""
    p, x = _case(1, q_lora)
    pt, pj = _both(p)
    pos = np.arange(96, dtype=np.int32)
    kw = dict(num_heads=4, kv_lora_rank=24, qk_nope_dim=16, qk_rope_dim=8,
              q_chunk=q_chunk, return_cache=True)
    y, cache = attn.mla_train(pt, t(x), t(pos), **kw)
    ry, rcache = ref_attn.mla_train(pj, jnp.asarray(x), jnp.asarray(pos), **kw)
    np.testing.assert_allclose(y.numpy(), np32(ry), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cache.c_kv.numpy(), np32(rcache.c_kv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cache.k_rope.numpy(), np32(rcache.k_rope),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("knn_k", [0, 16, 64])
@pytest.mark.parametrize("cur", [5, 90])
@pytest.mark.parametrize("q_lora", [0, 20])
def test_mla_decode_matches_reference(q_lora, cur, knn_k):
    """The absorbed decode over a latent cache of 96 positions, exact and
    kNN attention: output and the cache written at ``cur`` in place."""
    p, x = _case(2, q_lora)
    rng = np.random.default_rng(3)
    c_kv = rng.standard_normal((2, 96, 24), dtype=np.float32)
    k_rope = rng.standard_normal((2, 96, 8), dtype=np.float32)
    pt, pj = _both(p)
    kw = dict(num_heads=4, kv_lora_rank=24, qk_nope_dim=16, qk_rope_dim=8, knn_k=knn_k)
    cache = attn.MLACache(t(c_kv.copy()), t(k_rope.copy()))
    y, out = attn.mla_decode(pt, t(x[:, :1]), cache, cur, **kw)
    ry, rcache = ref_attn.mla_decode(pj, jnp.asarray(x[:, :1]),
                                     ref_attn.MLACache(jnp.asarray(c_kv),
                                                       jnp.asarray(k_rope)),
                                     jnp.int32(cur), **kw)
    np.testing.assert_allclose(y.numpy(), np32(ry), rtol=1e-5, atol=1e-5)
    assert out.c_kv is cache.c_kv and out.k_rope is cache.k_rope
    np.testing.assert_allclose(cache.c_kv.numpy(), np32(rcache.c_kv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(cache.k_rope.numpy(), np32(rcache.k_rope),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_smoke_matches_reference(dtype):
    """A prompt of 32: the prefill's 64 tokens are one dispatch group."""
    replay_matches_reference(NAME, dtype, prompt=32)


def test_deepseek_replay_equals_full_forward():
    """A capacity that drops nothing in the full forward's groups."""
    replay_equals_full_forward(NAME, moe_capacity_factor=8.0)
