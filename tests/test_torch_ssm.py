"""repro_torch.models.ssm (Mamba-2's SSD) and the ``ssm`` kind against
the reference.

The chunked SSD forward and the one-token decode take the reference's
seeded numpy inputs and parameters; f32 within 1e-5 relative
(``assert_allclose`` with atol 1e-5).  The decode writes the f32 state
and the conv window in place.  mamba2-2.7b-smoke runs whole through
``params.from_reference`` (prefill of 48 tokens, three chunks of 16;
f32 within 1e-4 of the largest |logit|, bf16 within 2^-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as ref_ssm
from repro_torch.models import ssm
from torch_lm_parity import (
    np32,
    replay_equals_full_forward,
    replay_matches_reference,
    t,
)

NAME = "mamba2-2.7b-smoke"
KW = dict(expand=2, head_dim=8, n_state=12)


def _params(seed, d=32):
    rng = np.random.default_rng(seed)
    p = {}
    for k, v in ssm.ssm_defs(d, **KW).items():
        p[k] = rng.standard_normal(v.shape, dtype=np.float32) * 0.3
    p["dt_bias"] = p["dt_bias"] - 1.0   # dt around softplus(-1): real decays
    return p


def test_ssm_defs_and_dims_match_reference():
    ours = ssm.ssm_defs(32, **KW)
    ref = ref_ssm.ssm_defs(32, **KW)
    assert {k: (v.shape, v.axes, v.init) for k, v in ours.items()} == \
        {k: (v.shape, v.axes, v.init) for k, v in ref.items()}
    assert ssm.ssm_dims(32, **KW) == ref_ssm.ssm_dims(32, **KW)


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssm_train_matches_reference(chunk):
    """32 positions as four chunks of 8 (the inter-chunk recurrence) or
    one chunk: output, final state and conv tail."""
    p = _params(1)
    x = np.random.default_rng(2).standard_normal((2, 32, 32), dtype=np.float32)
    y, cache = ssm.ssm_train({k: t(v) for k, v in p.items()}, t(x), chunk=chunk,
                             return_cache=True, **KW)
    ry, rcache = ref_ssm.ssm_train({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), chunk=chunk, return_cache=True, **KW)
    np.testing.assert_allclose(y.numpy(), np32(ry), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cache.state.numpy(), np32(rcache.state),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cache.conv.numpy(), np32(rcache.conv), rtol=1e-5, atol=1e-6)
    assert cache.state.dtype == torch.float32


def test_ssm_gradient_is_finite_over_a_long_chunk():
    """mamba2-2.7b's chunk of 256 at real decays: the anti-causal log
    decays sum past exp's f32 range.  The port masks them before the exp,
    so its gradients are finite and equal the reference's over chunks of
    16 (the SSD is the same function at any chunk); the reference's own
    gradients at a chunk of 256 are not finite (ROADMAP's reference
    caveats)."""
    import jax

    p = _params(3)
    p["a_log"] = np.full_like(p["a_log"], 0.5)     # a = -1.65, as the init
    p["dt_bias"] = np.full_like(p["dt_bias"], 1.0)
    x = np.random.default_rng(4).standard_normal((1, 256, 32), dtype=np.float32)
    c = np.random.default_rng(5).standard_normal((1, 256, 32), dtype=np.float32)
    ours = {k: t(v).requires_grad_() for k, v in p.items()}
    (ssm.ssm_train(ours, t(x), chunk=256, **KW) * t(c)).sum().backward()

    def ref_grads(chunk):
        def loss(q):
            return jnp.sum(ref_ssm.ssm_train(q, jnp.asarray(x), chunk=chunk, **KW) * c)
        return jax.grad(loss)({k: jnp.asarray(v) for k, v in p.items()})

    assert not all(np.all(np.isfinite(np32(g))) for g in ref_grads(256).values())
    want = ref_grads(16)
    for k, v in ours.items():
        g, w = v.grad.numpy(), np32(want[k])
        assert np.all(np.isfinite(g)), k
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)


def test_ssm_train_keeps_the_chunk_check():
    p = _params(1)
    with pytest.raises(ValueError, match="chunk"):
        ssm.ssm_train({k: t(v) for k, v in p.items()}, torch.zeros(1, 20, 32),
                      chunk=8, **KW)


def test_ssm_decode_matches_reference_in_place():
    """Eight steps from a random state and conv window: outputs against
    the reference's, the cache's tensors written in place."""
    p = _params(3)
    rng = np.random.default_rng(4)
    cache = ssm.ssm_init_cache(2, 32, **KW)
    cache.state.copy_(t(rng.standard_normal(cache.state.shape, dtype=np.float32)))
    cache.conv.copy_(t(rng.standard_normal(cache.conv.shape, dtype=np.float32)))
    # copies: jnp.asarray may alias a numpy buffer the port then writes
    rcache = ref_ssm.SSMCache(jnp.asarray(cache.state.numpy().copy()),
                              jnp.asarray(cache.conv.numpy().copy()))
    state, conv = cache.state, cache.conv
    pt = {k: t(v) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    for _ in range(8):
        x = rng.standard_normal((2, 1, 32), dtype=np.float32)
        y, cache = ssm.ssm_decode(pt, t(x), cache, **KW)
        ry, rcache = ref_ssm.ssm_decode(pj, jnp.asarray(x), rcache, **KW)
        np.testing.assert_allclose(y.numpy(), np32(ry), rtol=1e-5, atol=1e-5)
    assert cache.state is state and cache.conv is conv
    np.testing.assert_allclose(state.numpy(), np32(rcache.state), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(conv.numpy(), np32(rcache.conv), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_smoke_matches_reference(dtype):
    replay_matches_reference(NAME, dtype, prompt=48)


def test_mamba2_replay_equals_full_forward():
    """32 steps: the full forward's sequence is two chunks of 16."""
    replay_equals_full_forward(NAME, steps=32)
