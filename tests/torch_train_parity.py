"""Training parity helpers of the port's training tests.

A smoke config's reference train state (``repro.models.model
.init_train_state``) is carried into the port with
``params.from_reference``; the same ``SyntheticTokenSource`` batch goes
through the reference's ``loss_fn``/``jax.grad``/``make_train_step`` and
the port's.  Batches are 2 x 32 tokens: a MoE group (64 tokens) and
mamba's SSD chunk (16) divide them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.data.pipeline import SyntheticTokenSource as RefSource
from repro.models import model as ref_model
import repro_torch.configs as port_configs
from repro_torch.models import model as M
from repro_torch.models import params

@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's side while a module runs: the
    smoke shapes gain nothing from more, and the suite's other workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SMOKE = sorted(n for n in port_configs.list_configs() if n.endswith("-smoke"))
# The parity cases by test file.  ``pytest -n --dist loadfile`` runs each
# file on one worker, and the ten configs' f32 cases (two routers for the
# MoE ones) take about 240 s of one CPU worker, the bf16 cases about
# 145 s, most of it the reference's compilation, so they are spread over
# test_torch_train{,_moe,_mla,_families}.py (f32, 40-60 s each) and
# test_torch_train_bf16{,_families}.py (55 and 90 s).
# test_torch_train.py::test_parity_cases_cover_every_smoke_config checks
# that together they hold every smoke config.
DENSE = ["granite-20b-smoke", "internlm2-1.8b-smoke", "qwen2-vl-2b-smoke",
         "stablelm-1.6b-smoke", "starcoder2-7b-smoke"]
MOE, MLA = "granite-moe-3b-a800m-smoke", "deepseek-v2-236b-smoke"
RECURRENT_ENCDEC = ["mamba2-2.7b-smoke", "recurrentgemma-9b-smoke",
                    "whisper-medium-smoke"]
ROUTERS = ["exact", "approx"]
BATCH, SEQ = 2, 32
LR = 1e-3


def configs(name, **changes):
    """(port cfg, reference cfg) of ``name`` with ``changes``."""
    return (dataclasses.replace(port_configs.get_config(name), **changes),
            dataclasses.replace(ref_configs.get_config(name), **changes))


def source(cfg, seq=SEQ, batch=BATCH, seed=1):
    return RefSource(
        cfg.vocab_size, seq, batch, seed=seed,
        input_mode=cfg.input_mode if not cfg.is_encoder_decoder else "tokens",
        d_model=cfg.d_model,
        enc_seq=cfg.encoder_seq if cfg.is_encoder_decoder else 0,
        mrope=cfg.mrope)


def to_port(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def to_ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def states(cfg, rcfg, seed=3):
    """(port TrainState, reference TrainState) holding the reference's
    random f32 parameters and zero moments."""
    ref = jax.jit(ref_model.init_train_state, static_argnums=1)(
        jax.random.PRNGKey(seed), rcfg)
    state = M.init_train_state(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    with torch.no_grad():
        for name, t in params.from_reference(ref.params, cfg).items():
            state.params.get_parameter(name).copy_(t)
    return state, ref


def ref_grads(ref_params, cfg, rcfg, batch):
    """The reference's loss and gradients, by the port's names."""
    fn = jax.jit(jax.value_and_grad(ref_model.loss_fn), static_argnums=1)
    loss, grads = fn(ref_params, rcfg, to_ref(batch))
    return float(loss), params.from_reference(jax.tree.map(np.asarray, grads), cfg)


def port_grads(state, cfg, batch):
    """The port's loss and its gradients (a dict by parameter name; a
    parameter the loss does not reach gets zeros, as ``jax.grad``'s)."""
    model = state.params
    for p in model.parameters():
        p.grad = None
    loss = M.loss_fn(model, cfg, to_port(batch))
    loss.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), grads


def ref_grads_and_step(ref_state, cfg, rcfg, batch, **kw):
    """The reference's loss and gradients (by the port's names) and one
    ``make_train_step`` from ``ref_state``, compiled as one program."""
    step = ref_model.make_train_step(rcfg, **kw)

    def both(state, b):
        return (jax.value_and_grad(ref_model.loss_fn)(state.params, rcfg, b),
                step(state, b))

    (loss, grads), (new_state, metrics) = jax.jit(both)(ref_state, to_ref(batch))
    grads = params.from_reference(jax.tree.map(np.asarray, grads), cfg)
    return float(loss), grads, new_state, metrics


def ref_step(ref_state, rcfg, batch, **kw):
    step = jax.jit(ref_model.make_train_step(rcfg, **kw))
    return step(ref_state, to_ref(batch))


def port_params(state):
    return {n: p.detach().clone() for n, p in state.params.named_parameters()}


def assert_step_close(state, ref_state, cfg, grads_ref, rtol=1e-5, atol=1e-6,
                      floor=1e-6):
    """Parameters after a step allclose to the reference's where its
    gradient is at least ``floor`` in magnitude; returns the count of
    entries left out (Adam's first update takes the sign of a rounding
    error below it)."""
    want = params.from_reference(jax.tree.map(np.asarray, ref_state.params), cfg)
    skipped = 0
    for name, p in state.params.named_parameters():
        ours, ref = p.detach().numpy(), want[name].numpy()
        big = np.abs(grads_ref[name].numpy()) >= floor
        skipped += int((~big).sum())
        np.testing.assert_allclose(ours[big], ref[big], rtol=rtol, atol=atol,
                                   err_msg=name)
    return skipped


def check_f32_step(name, **changes):
    """At ``dtype="float32"``: ``loss_fn`` (rtol 1e-5), every gradient
    leaf (``jax.grad``'s, mapped by ``params.from_reference``; rtol 1e-4,
    atol 1e-6), one ``make_train_step``'s loss and grad_norm (rtol 1e-5)
    and parameters (rtol 1e-5, atol 1e-6 where the reference's gradient
    is at least 1e-6 in magnitude; the count left out is printed)."""
    cfg, rcfg = configs(name, dtype="float32", **changes)
    state, ref = states(cfg, rcfg)
    batch = source(cfg).batch(0)
    loss, grads = port_grads(state, cfg, batch)
    rloss, rgrads, ref, rmetrics = ref_grads_and_step(ref, cfg, rcfg, batch,
                                                      learning_rate=LR)
    np.testing.assert_allclose(loss, rloss, rtol=1e-5)
    assert set(grads) == set(rgrads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), rgrads[n].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)
    state, metrics = M.make_train_step(cfg, learning_rate=LR)(state, to_port(batch))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(rmetrics[key]),
                                   rtol=1e-5, err_msg=key)
    assert int(state.step) == int(ref.step) == 1
    skipped = assert_step_close(state, ref, cfg, rgrads)
    print(f"{name} {changes}: {skipped} entries with |grad| < 1e-6 left out")


def check_bf16_step(name):
    """The config as shipped (``dtype="bfloat16"``): one step's loss and
    grad_norm finite and within rtol 2e-2 of the reference's."""
    cfg, rcfg = configs(name)
    assert cfg.dtype == "bfloat16"
    state, ref = states(cfg, rcfg)
    batch = source(cfg).batch(0)
    _, metrics = M.make_train_step(cfg, learning_rate=LR)(state, to_port(batch))
    _, rmetrics = ref_step(ref, rcfg, batch, learning_rate=LR)
    for key in ("loss", "grad_norm"):
        ours = float(metrics[key])
        assert np.isfinite(ours)
        np.testing.assert_allclose(ours, float(rmetrics[key]), rtol=2e-2,
                                   err_msg=key)
