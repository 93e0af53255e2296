"""repro_torch.models.rglru, the ``rglru`` and ``local_attn`` kinds
against the reference.

The RG-LRU block takes the reference's seeded numpy inputs and
parameters (dense and block-diagonal gates; the log-depth associative
scan, and the chunked ``"linear"`` scan at S=512); f32 within 1e-5
relative (``assert_allclose`` with atol 1e-5).  Local attention's ring
buffer: ``_to_ring_cache``'s roll and decode steps past the window, so
the ring wraps.  recurrentgemma-9b-smoke (window 16) runs whole through
``params.from_reference``, its 24 replayed steps wrapping the ring (f32
within 1e-4 of the largest |logit|, bf16 within 2^-5), also with
block-diagonal gates.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import rglru as ref_rglru
from repro.models import transformer as ref_tfm
import repro_torch.configs as port_configs
from repro_torch.models import attention as attn
from repro_torch.models import rglru
from repro_torch.models import transformer as tfm
from torch_lm_parity import (
    np32,
    replay_equals_full_forward,
    replay_matches_reference,
    t,
)

NAME = "recurrentgemma-9b-smoke"


def _params(seed, *, d=16, lru=32, gate_blocks=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape, dtype=np.float32) * 0.3
            for k, v in rglru.rglru_defs(d, lru, gate_blocks=gate_blocks).items()}


def _both(p):
    return ({k: t(v) for k, v in p.items()}, {k: jnp.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("gate_blocks", [0, 4])
def test_rglru_defs_match_reference(gate_blocks):
    ours = rglru.rglru_defs(16, 32, gate_blocks=gate_blocks)
    ref = ref_rglru.rglru_defs(16, 32, gate_blocks=gate_blocks)
    assert {k: (v.shape, v.axes, v.init) for k, v in ours.items()} == \
        {k: (v.shape, v.axes, v.init) for k, v in ref.items()}


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 64])
def test_associative_scan_is_the_recurrence(n):
    """The torch odd/even scan against the sequential recurrence at odd and
    even lengths (f32, within a few ulps)."""
    rng = np.random.default_rng(n)
    a = t(rng.uniform(0.5, 1.0, (2, n, 3)).astype(np.float32))
    b = t(rng.standard_normal((2, n, 3), dtype=np.float32))
    pa, h = rglru._associative_scan(a, b)
    want, prod, state = [], torch.ones(2, 3), torch.zeros(2, 3)
    for i in range(n):
        state = a[:, i] * state + b[:, i]
        prod = prod * a[:, i]
        want.append(state)
    np.testing.assert_allclose(h.numpy(), torch.stack(want, 1).numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pa[:, -1].numpy(), prod.numpy(), rtol=1e-5)


@pytest.mark.parametrize("scan_impl,s", [("associative", 40), ("linear", 512)])
@pytest.mark.parametrize("gate_blocks", [0, 4])
def test_rglru_train_matches_reference(scan_impl, s, gate_blocks):
    """``"linear"`` scans two chunks of 256 at S=512."""
    pt, pj = _both(_params(1, gate_blocks=gate_blocks))
    x = np.random.default_rng(2).standard_normal((2, s, 16), dtype=np.float32)
    y, cache = rglru.rglru_train(pt, t(x), return_cache=True, scan_impl=scan_impl)
    ry, rcache = jax.jit(ref_rglru.rglru_train,
                         static_argnames=("return_cache", "scan_impl"))(
        pj, jnp.asarray(x), return_cache=True, scan_impl=scan_impl)
    np.testing.assert_allclose(y.numpy(), np32(ry), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cache.state.numpy(), np32(rcache.state),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cache.conv.numpy(), np32(rcache.conv), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("gate_blocks", [0, 4])
def test_rglru_decode_matches_reference_in_place(gate_blocks):
    pt, pj = _both(_params(3, gate_blocks=gate_blocks))
    rng = np.random.default_rng(4)
    cache = rglru.rglru_init_cache(2, 32)
    cache.state.copy_(t(rng.standard_normal((2, 32), dtype=np.float32)))
    # copies: jnp.asarray may alias a numpy buffer the port then writes
    rcache = ref_rglru.RGLRUCache(jnp.asarray(cache.state.numpy().copy()),
                                  jnp.asarray(cache.conv.numpy().copy()))
    state, conv = cache.state, cache.conv
    for _ in range(6):
        x = rng.standard_normal((2, 1, 16), dtype=np.float32)
        y, cache = rglru.rglru_decode(pt, t(x), cache)
        ry, rcache = ref_rglru.rglru_decode(pj, jnp.asarray(x), rcache)
        np.testing.assert_allclose(y.numpy(), np32(ry), rtol=1e-5, atol=1e-5)
    assert cache.state is state and cache.conv is conv
    np.testing.assert_allclose(state.numpy(), np32(rcache.state), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(conv.numpy(), np32(rcache.conv), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s", [40, 48, 10])
def test_to_ring_cache_rolls_as_reference(s):
    """Slot j holds the position p with p % w == j: a roll by s % 16 of
    the last 16 positions (none at 48; a short prompt keeps all 10)."""
    cfg = port_configs.get_config(NAME)
    rng = np.random.default_rng(s)
    k, v = (rng.standard_normal((2, s, 1, 16), dtype=np.float32) for _ in range(2))
    pos = np.arange(s, dtype=np.int32)
    ours = tfm._to_ring_cache(attn.KVCache(t(k), t(v)), t(pos), cfg)
    ref = ref_tfm._to_ring_cache(ref_attn.KVCache(jnp.asarray(k), jnp.asarray(v)),
                                 jnp.asarray(pos), ref_configs.get_config(NAME))
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert (ours.pos.numpy() % min(16, s) == np.arange(min(16, s))).all()


def test_local_attention_decode_wraps_the_ring():
    """40 decode steps into a window of 16 slots (the ring wraps twice):
    each step's output and the ring (keys, values, positions) against
    the reference's, written in place."""
    cfg = dataclasses.replace(port_configs.get_config(NAME), dtype="float32")
    rcfg = dataclasses.replace(ref_configs.get_config(NAME), dtype="float32")
    rng = np.random.default_rng(9)
    p = {k: rng.standard_normal(d.shape, dtype=np.float32) * 0.2
         for k, d in attn.attn_defs(64, 4, 1, 16).items()}
    pt, pj = _both(p)
    cache = tfm.init_layer_cache(cfg, "local_attn", 2, 160, device="cpu")
    rcache = ref_tfm.init_layer_cache(rcfg, "local_attn", 2, 160)
    assert cache.k.shape[1] == 16 and (cache.pos.numpy() == -1).all()
    k0 = cache.k
    ref_step = jax.jit(ref_tfm._local_attn_decode, static_argnums=4)
    for i in range(40):
        x = rng.standard_normal((2, 1, 64), dtype=np.float32)
        y, cache = tfm._local_attn_decode(pt, t(x), cache, i, cfg)
        ry, rcache = ref_step(pj, jnp.asarray(x), rcache, jnp.int32(i), rcfg)
        np.testing.assert_allclose(y.numpy(), np32(ry), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(rcache.pos))
    assert cache.k is k0
    np.testing.assert_allclose(cache.k.numpy(), np32(rcache.k), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrentgemma_smoke_matches_reference(dtype):
    """A 40-token prefill (the ring rolled by 8), then 24 replayed steps
    (the decode ring of 16 wraps)."""
    replay_matches_reference(NAME, dtype, steps=24)


def test_recurrentgemma_block_gates_match_reference():
    """The opt variant's block-diagonal gates (4 blocks at smoke width), at
    f32."""
    replay_matches_reference(NAME, "float32", lru_gate_blocks=4)


def test_recurrentgemma_replay_equals_full_forward():
    """24 steps: the window of 16 slides inside the replay."""
    replay_equals_full_forward(NAME, steps=24)
