"""The port's AdamW and learning-rate schedules against the reference's,
on the CPU: ``adamw_update`` fed the same parameters, gradients and
state (rtol 1e-6, atol 1e-7; f32 and bf16 parameters, a float and a
schedule as the learning rate, several steps), and both schedules at
steps 0..N (rtol 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro_torch.optim import adamw


def _tree(rng, dtype=np.float32):
    return {"a": rng.standard_normal((7, 5)).astype(dtype),
            "b": {"c": rng.standard_normal((13,)).astype(dtype)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("lr", ["float", "cosine", "warmup"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(lr, dtype):
    rng = np.random.default_rng(0)
    sched = {"float": (3e-3, 3e-3),
             "cosine": (adamw.cosine_schedule(1e-2, 2, 6),
                        ref_adamw.cosine_schedule(1e-2, 2, 6)),
             "warmup": (adamw.linear_warmup(1e-2, 3),
                        ref_adamw.linear_warmup(1e-2, 3))}[lr]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), _tree(rng))
    params = {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(tdt)
              for k, v in _flat(rparams).items()}
    rstate = ref_adamw.adamw_init(rparams)
    state = adamw.adamw_init(params)
    for step in range(5):
        g = _tree(rng)
        rparams, rstate = ref_adamw.adamw_update(
            rparams, jax.tree.map(jnp.asarray, g), rstate,
            step=jnp.int32(step), learning_rate=sched[1], weight_decay=0.1)
        params, state = adamw.adamw_update(
            params, {k: torch.from_numpy(v) for k, v in _flat(g).items()},
            state, step=step, learning_rate=sched[0], weight_decay=0.1)
        for name, ref in _flat(rparams).items():
            np.testing.assert_allclose(
                params[name].float().numpy(), np.asarray(ref.astype(jnp.float32)),
                rtol=1e-6 if dtype == "float32" else 2 ** -8, atol=1e-7,
                err_msg=(step, name))
        for which in ("m", "v"):
            for name, ref in _flat(getattr(rstate, which)).items():
                ours = getattr(state, which)[name]
                assert ours.dtype == torch.float32
                np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                           rtol=1e-6, atol=1e-7)


def test_adamw_update_is_in_place():
    p = {"w": torch.ones(4)}
    state = adamw.adamw_init(p)
    w = p["w"]
    out, state2 = adamw.adamw_update(p, {"w": torch.ones(4)}, state, step=0)
    assert out["w"] is w and state2.m["w"] is state.m["w"]
    assert (w < 1).all()


def test_schedules_match_reference():
    for ours, ref, n in (
        (adamw.cosine_schedule(3e-4, 20, 100), ref_adamw.cosine_schedule(3e-4, 20, 100), 130),
        (adamw.cosine_schedule(1e-3, 5, 5, 0.2), ref_adamw.cosine_schedule(1e-3, 5, 5, 0.2), 12),
        (adamw.linear_warmup(1e-3, 7), ref_adamw.linear_warmup(1e-3, 7), 20),
    ):
        got = np.array([ours(i) for i in range(n)])
        want = np.array([float(ref(jnp.int32(i))) for i in range(n)])
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert all(isinstance(ours(torch.tensor(i)), float) for i in (0, 3))
