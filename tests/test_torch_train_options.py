"""The port's training step's options against the reference's, on the
CPU (internlm2-1.8b-smoke at f32 unless named): ``microbatches=2``,
``grad_dtype="bfloat16"``, a cosine schedule as the learning rate, the
three remat settings; the serving forwards' no-grad; ``input_specs`` on
the meta device.  Tolerances beside each test.
"""
import jax
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from repro.models import model as ref_model
from torch_train_parity import (  # noqa: F401 (few_threads: a fixture)
    LR,
    assert_step_close,
    configs,
    few_threads,
    port_grads,
    ref_grads,
    ref_step,
    source,
    states,
    to_port,
    to_ref,
)
from repro_torch.models import model as M

NAME = "internlm2-1.8b-smoke"


def test_microbatches_match_reference_and_one_batch():
    """``microbatches=2`` against the reference's (f32: loss and
    grad_norm rtol 1e-5, parameters as the f32 step) and against the
    port's ``microbatches=1`` (the same tolerances)."""
    cfg, rcfg = configs(NAME, dtype="float32")
    batch = source(cfg, batch=4).batch(0)
    state, ref = states(cfg, rcfg)
    _, rgrads = ref_grads(ref.params, cfg, rcfg, batch)
    state, metrics = M.make_train_step(cfg, learning_rate=LR, microbatches=2)(
        state, to_port(batch))
    ref, rmetrics = ref_step(ref, rcfg, batch, learning_rate=LR, microbatches=2)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(rmetrics[key]),
                                   rtol=1e-5)
    assert_step_close(state, ref, cfg, rgrads)
    one, _ = states(cfg, rcfg)
    one, m1 = M.make_train_step(cfg, learning_rate=LR)(one, to_port(batch))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(m1[key]), rtol=1e-5)
    for (n, p), q in zip(state.params.named_parameters(), one.params.parameters()):
        big = rgrads[n].abs() >= 1e-6
        np.testing.assert_allclose(p.detach()[big].numpy(), q.detach()[big].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_bf16_gradients_match_reference():
    """``grad_dtype="bfloat16"`` (the compressed reduction) against the
    reference's: loss rtol 1e-5, grad_norm rtol 1e-5 (the norm is taken
    of the rounded gradients), parameters as the f32 step."""
    cfg, rcfg = configs(NAME, dtype="float32")
    batch = source(cfg).batch(2)
    state, ref = states(cfg, rcfg)
    _, rgrads = ref_grads(ref.params, cfg, rcfg, batch)
    state, metrics = M.make_train_step(cfg, learning_rate=LR,
                                       grad_dtype="bfloat16")(state, to_port(batch))
    ref, rmetrics = ref_step(ref, rcfg, batch, learning_rate=LR,
                             grad_dtype="bfloat16")
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(rmetrics[key]),
                                   rtol=1e-5)
    assert_step_close(state, ref, cfg, rgrads)


def test_schedule_steps_match_reference():
    """Three steps under the reference's cosine schedule as
    ``learning_rate``: each step's loss (rtol 1e-5), and the parameters
    after them (rtol 1e-4, atol 1e-5, where the first gradient is at
    least 1e-6: from the second step on, Adam's moments sum gradients of
    both signs, and an entry whose sum cancels takes its rounding)."""
    from repro.optim.adamw import cosine_schedule as ref_cosine
    from repro_torch.optim.adamw import cosine_schedule

    cfg, rcfg = configs(NAME, dtype="float32")
    src = source(cfg)
    state, ref = states(cfg, rcfg)
    _, rgrads = ref_grads(ref.params, cfg, rcfg, src.batch(0))
    step = M.make_train_step(cfg, learning_rate=cosine_schedule(3e-3, 2, 10))
    rstep = jax.jit(ref_model.make_train_step(rcfg, learning_rate=ref_cosine(3e-3, 2, 10)))
    for i in range(3):
        state, metrics = step(state, to_port(src.batch(i)))
        ref, rmetrics = rstep(ref, to_ref(src.batch(i)))
        np.testing.assert_allclose(float(metrics["loss"]), float(rmetrics["loss"]),
                                   rtol=1e-5)
    assert int(state.step) == 3
    assert_step_close(state, ref, cfg, rgrads, rtol=1e-4, atol=1e-5)


def _saved_bytes(cfg, state, batch):
    """Bytes autograd holds for the backward after a forward under
    ``cfg.remat`` (the packed tensors of saved-tensor hooks)."""
    total = []

    def pack(t):
        total.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = M.loss_fn(state.params, cfg, to_port(batch))
    loss.backward()
    for p in state.params.parameters():
        p.grad = None
    return sum(total)


@pytest.mark.parametrize("name", ["internlm2-1.8b-smoke", "granite-moe-3b-a800m-smoke",
                                  "mamba2-2.7b-smoke", "recurrentgemma-9b-smoke",
                                  "whisper-medium-smoke"])
def test_remat_settings_give_equal_gradients(name, monkeypatch):
    """``remat`` "none", "full" and "dots" give the same gradients (rtol
    1e-6, atol 1e-9: the recomputation runs the same ops).  Outside the
    checkpointed layers "full" and "dots" hold less for the backward than
    "none"; inside, "dots" saves the outputs of ``aten.mm``/``addmm``
    (the matmuls without batch dims) and nothing else."""
    from repro_torch.models import transformer as tfm

    decisions = []

    def policy(ctx, op, *args, **kwargs):
        out = tfm_policy(ctx, op, *args, **kwargs)
        decisions.append((op, out))
        return out

    tfm_policy = tfm._dots_policy
    monkeypatch.setattr(tfm, "_dots_policy", policy)
    grads, held = {}, {}
    for remat in ("none", "full", "dots"):
        cfg, _ = configs(name, dtype="float32", remat=remat)
        state = M.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
        batch = source(cfg).batch(1)
        held[remat] = _saved_bytes(cfg, state, batch)
        grads[remat] = port_grads(state, cfg, batch)
    for remat in ("full", "dots"):
        assert grads[remat][0] == grads["none"][0]
        for n, g in grads["none"][1].items():
            np.testing.assert_allclose(grads[remat][1][n].numpy(), g.numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=(remat, n))
        assert held[remat] < held["none"], held
    saved = {op for op, d in decisions if d == CheckpointPolicy.MUST_SAVE}
    assert saved <= tfm._DOTS, saved
    assert saved and any(d != CheckpointPolicy.MUST_SAVE for _, d in decisions)


def test_serving_forward_records_no_graph():
    """The serving forwards run without autograd, and a model whose
    parameters do not require grad records none in ``forward_train``."""
    from repro_torch.models import transformer as tfm

    cfg, _ = configs(NAME)
    model = tfm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    assert not tfm.forward_train(model, toks).requires_grad
    model.requires_grad_(True)
    assert tfm.forward_train(model, toks).requires_grad
    logits, _ = tfm.forward_prefill(model, toks)
    assert not logits.requires_grad


def test_input_specs_match_reference():
    """``input_specs`` on the meta device: the reference's keys, shapes
    and dtypes for train, prefill and decode (the decode caches one a
    layer where the reference stacks them per run)."""
    import repro_torch.configs as C

    for name in ("internlm2-1.8b-smoke", "qwen2-vl-2b-smoke", "whisper-medium-smoke"):
        cfg, rcfg = configs(name)
        for kind in ("train", "prefill", "decode"):
            shape = C.ShapeConfig(kind, 64, 4, kind)
            ours = M.input_specs(cfg, shape)
            theirs = ref_model.input_specs(rcfg, shape)
            assert sorted(ours) == sorted(theirs)
            for k, v in ours.items():
                if k in ("caches", "cross_kv"):
                    leaves = [x for c in v if c is not None for x in c]
                    assert all(x.device.type == "meta" for x in leaves)
                    continue
                ref = theirs[k]
                assert v.device.type == "meta"
                assert tuple(v.shape) == tuple(ref.shape), (name, kind, k)
                assert str(v.dtype).split(".")[-1] == str(ref.dtype), (name, kind, k)
            if kind == "decode":
                n_ref = sum(x.shape[0] for x in jax.tree.leaves(theirs["caches"])
                            if x.ndim) // len(ours["caches"][0])
                assert len(ours["caches"]) == len(cfg.layer_kinds())
                assert n_ref == len(cfg.layer_kinds())
