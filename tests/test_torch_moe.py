"""repro_torch.models.moe and the ``moe`` kind against the reference.

The layer takes the reference's seeded numpy inputs and parameters; f32
within 1e-5 relative (``assert_allclose`` with atol 1e-6).  Routing is
compared exactly at f32 (experts, queue places and drops), and at bf16
only for tokens whose k-th and (k+1)-th probabilities are apart by more
than bf16's rounding.  granite-moe-3b-a800m-smoke runs whole through
``params.from_reference`` (prefill, then 12 replayed decode steps, exact
and kNN attention; f32 within 1e-4 of the largest |logit|, bf16 within
2^-5), also with the approx router.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro_torch.models import moe
from torch_lm_parity import (
    np32,
    replay_equals_full_forward,
    replay_matches_reference,
    t,
)

NAME = "granite-moe-3b-a800m-smoke"


def _case(seed, *, b=2, s=10, d=16, f=12, e=8, shared=0):
    rng = np.random.default_rng(seed)
    p = {k: (rng.standard_normal(v.shape, dtype=np.float32) * 0.3)
         for k, v in moe.moe_defs(d, f, e, num_shared_experts=shared).items()}
    x = rng.standard_normal((b, s, d), dtype=np.float32)
    return p, x


def _ref_routing(p, x, *, k, e, cap, routing="exact", dtype=jnp.float32):
    """The reference's router and queue places (``moe.py:80-92``), one
    group: (probabilities (t, E), experts (t, k), places (t, k), kept)."""
    xt = jnp.asarray(x, dtype).reshape(1, -1, x.shape[-1])
    logits = jnp.einsum("Gtd,de->Gte", xt, jnp.asarray(p["router"], dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, top_e = ref_moe._router_topk(probs, k, routing, 0.95)
    sel = jax.nn.one_hot(top_e, e, dtype=jnp.int32)
    pos = jnp.cumsum(sel.reshape(1, -1, e), axis=1).reshape(sel.shape) * sel - 1
    place = jnp.take_along_axis(pos, top_e[..., None], -1)[..., 0]
    return (np.asarray(probs[0]), np.asarray(top_e[0]), np.asarray(place[0]),
            np.asarray(place[0] < cap))


@pytest.mark.parametrize("group_size", [64, 10])
@pytest.mark.parametrize("routing", ["exact", "approx"])
@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("capacity_factor", [1.5, 0.5])
def test_moe_apply_matches_reference(routing, shared, capacity_factor, group_size):
    """20 tokens, 8 experts, top-2, in one group or two: at capacity factor
    0.5 one group's capacity is round(2.5) = 2 (halves to even, the
    reference's Python round) and pairs are dropped; the output carries
    every kept pair."""
    p, x = _case(1, shared=shared)
    kw = dict(experts_per_token=2, num_experts=8, capacity_factor=capacity_factor,
              group_size=group_size, routing=routing)
    y = moe.moe_apply({k: t(v) for k, v in p.items()}, t(x), **kw)
    ry = ref_moe.moe_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                           **kw)
    np.testing.assert_allclose(y.numpy(), np32(ry), rtol=1e-5, atol=1e-6)
    assert moe._capacity(20, 2, 8, capacity_factor) == (2 if capacity_factor == 0.5
                                                        else 8)


@pytest.mark.parametrize("routing", ["exact", "approx"])
def test_kept_slots_equal_reference_when_tokens_drop(routing):
    """Capacity factor 0.5: every pair's expert, queue place and kept flag
    equal the reference's, and some pairs are dropped."""
    p, x = _case(2, s=20)
    cap = moe._capacity(40, 2, 8, 0.5)
    w, e, place, kept = moe._route({k: t(v) for k, v in p.items()},
                                   t(x).reshape(1, 40, 16), experts_per_token=2,
                                   num_experts=8, cap=cap, routing=routing)
    _, re, rplace, rkept = _ref_routing(p, x, k=2, e=8, cap=cap, routing=routing)
    np.testing.assert_array_equal(e[0].numpy(), re)
    np.testing.assert_array_equal(place[0].numpy(), rplace)
    np.testing.assert_array_equal(kept[0].numpy(), rkept)
    assert not rkept.all()
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_exact_router_breaks_ties_to_the_lowest_expert():
    """Equal router logits: lax.top_k's lowest-index rule, not
    torch.topk's unspecified order."""
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    _, idx = moe._router_topk(probs, 2, "exact", 0.95)
    _, ridx = ref_moe._router_topk(jnp.asarray(probs.numpy()), 2, "exact", 0.95)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(idx.numpy(), [[1, 2], [0, 1]])


def test_bf16_routing_equals_reference_where_the_margin_is_clear():
    """At bf16 the router's logits round differently in the two libraries;
    where the reference's k-th and (k+1)-th probabilities are apart by
    more than 2^-7 (a logit's bf16 rounding moves a probability by well
    under 1% of itself) the chosen experts are the same set, and such
    tokens are the majority."""
    p, x = _case(3, s=64)
    k, e = 2, 8
    tp = {key: t(v).to(torch.bfloat16) for key, v in p.items()}
    _, top_e, _, _ = moe._route(tp, t(x).to(torch.bfloat16).reshape(1, 128, 16),
                                experts_per_token=k, num_experts=e, cap=128)
    probs, re, _, _ = _ref_routing(p, x, k=k, e=e, cap=128, dtype=jnp.bfloat16)
    srt = -np.sort(-probs, axis=-1)
    clear = srt[:, k - 1] - srt[:, k] > 2.0 ** -7
    assert clear.sum() >= len(clear) // 2
    ours = np.sort(top_e[0].numpy(), axis=-1)[clear]
    np.testing.assert_array_equal(ours, np.sort(re, axis=-1)[clear])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routing", ["exact", "approx"])
def test_granite_moe_smoke_matches_reference(dtype, routing):
    """A prompt of 32: the prefill's 64 tokens are one dispatch group."""
    replay_matches_reference(NAME, dtype, prompt=32, router_topk_impl=routing)


def test_granite_moe_replay_equals_full_forward():
    """A capacity that drops nothing (a drop in the full forward's groups
    has no counterpart in a one-token step)."""
    replay_equals_full_forward(NAME, moe_capacity_factor=8.0)
