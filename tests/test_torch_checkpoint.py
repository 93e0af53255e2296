"""The port's training checkpoints against the reference's format, on the
CPU: a port checkpoint restores in the reference's ``restore_checkpoint``
into its ``init_train_state`` structure bit for bit, a reference
checkpoint restores in the port bit for bit, the ``leaf_paths`` lists are
equal, ``.tmp`` directories are ignored, ``keep=`` garbage collection
works, the host copy is taken at ``save``, and an exact resume matches an
uninterrupted run (as ``tests/test_system.py::
test_checkpoint_restart_exact_resume`` shows for the reference)."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ck
from repro.models import model as ref_model
import repro_torch.configs as port_configs
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.data.pipeline import SyntheticTokenSource
from repro_torch.models import model as M
from repro_torch.models import params

from torch_train_parity import configs, source, to_port, few_threads  # noqa: F401 (a fixture)

NAMES = ["recurrentgemma-9b-smoke", "whisper-medium-smoke", "deepseek-v2-236b-smoke"]


def _stepped(name, steps=1):
    """A port train state after ``steps`` steps (moments non-zero)."""
    cfg = port_configs.get_config(name)
    state = M.init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    step = M.make_train_step(cfg, learning_rate=1e-3)
    src = source(cfg)
    for i in range(steps):
        state, _ = step(state, to_port(src.batch(i)))
    return cfg, state


def _ref_like(name):
    rcfg = configs(name)[1]
    return jax.eval_shape(lambda: ref_model.init_train_state(jax.random.PRNGKey(0), rcfg))


def _leaf_paths(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "META.json")) as f:
        return json.load(f)["leaf_paths"]


@pytest.mark.parametrize("name", NAMES)
def test_port_checkpoint_restores_in_the_reference(tmp_path, name):
    cfg, state = _stepped(name)
    ck.save_checkpoint(str(tmp_path), 1, state)
    like = _ref_like(name)
    assert _leaf_paths(tmp_path, 1) == [k for k, _ in ref_ck._flatten_with_paths(like)]
    restored, at = ref_ck.restore_checkpoint(str(tmp_path), like)
    assert at == 1 and int(restored.step) == int(state.step) == 1
    want = {n: p.detach() for n, p in state.params.named_parameters()}
    for tree, ours in ((restored.params, want), (restored.opt_state.m, state.opt_state.m),
                       (restored.opt_state.v, state.opt_state.v)):
        got = params.from_reference(jax.tree.map(np.asarray, tree), cfg)
        assert sorted(got) == sorted(ours)
        for n, t in ours.items():
            assert torch.equal(got[n], t), n


@pytest.mark.parametrize("name", NAMES)
def test_reference_checkpoint_restores_in_the_port(tmp_path, name):
    """A reference train state of the reference's structure, every leaf
    drawn from numpy (moments too), through the reference's writer."""
    cfg = configs(name)[0]
    rng = np.random.default_rng(2)
    ref = jax.tree.map(
        lambda s: (np.int32(11) if s.dtype == np.int32
                   else rng.standard_normal(s.shape).astype(s.dtype)),
        _ref_like(name))
    ref_ck.save_checkpoint(str(tmp_path), 7, ref)
    like = M.init_train_state(torch.Generator().manual_seed(5), cfg, device="cpu")
    state, at = ck.restore_checkpoint(str(tmp_path), like)
    assert at == 7 and int(state.step) == 11 and state.step.dtype == torch.int32
    for tree, ours in ((ref.params, dict(state.params.named_parameters())),
                       (ref.opt_state.m, state.opt_state.m),
                       (ref.opt_state.v, state.opt_state.v)):
        want = params.from_reference(jax.tree.map(np.asarray, tree), cfg)
        for n, t in ours.items():
            assert torch.equal(t.detach(), want[n]), n
    # and back: the port writes what it restored, the same paths and bits
    ck.save_checkpoint(str(tmp_path / "again"), 7, state)
    assert _leaf_paths(tmp_path / "again", 7) == _leaf_paths(tmp_path, 7)
    with np.load(tmp_path / "step_00000007" / "arrays.npz") as a, \
            np.load(tmp_path / "again" / "step_00000007" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_tmp_dirs_are_ignored_and_keep_collects(tmp_path):
    cfg, state = _stepped("internlm2-1.8b-smoke", steps=0)
    d = str(tmp_path)
    assert ck.latest_step(d) is None and ck.latest_step(d + "/none") is None
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(d, state)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))  # an interrupted write
    os.makedirs(os.path.join(d, "step_00000008"))      # no META.json: uncommitted
    assert ck.latest_step(d) is None and ref_ck.latest_step(d) is None
    os.rmdir(os.path.join(d, "step_00000008"))  # the collector counts it (as the reference's)
    writer = ck.AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3):
        writer.save(s, state)
    writer.wait()
    assert ck.latest_step(d) == ref_ck.latest_step(d) == 3
    kept = sorted(n for n in os.listdir(d) if not n.endswith(".tmp"))
    assert kept == ["step_00000002", "step_00000003"]


def test_async_save_copies_the_state_at_save(tmp_path):
    cfg, state = _stepped("stablelm-1.6b-smoke", steps=1)
    before = {n: p.detach().clone() for n, p in state.params.named_parameters()}
    writer = ck.AsyncCheckpointer(str(tmp_path))
    writer.save(1, state)
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(1.0)
    writer.wait()
    like = M.init_train_state(torch.Generator().manual_seed(9), cfg, device="cpu")
    restored, _ = ck.restore_checkpoint(str(tmp_path), like)
    for n, p in restored.params.named_parameters():
        assert torch.equal(p.detach(), before[n]), n


def test_tree_checkpoints_round_trip(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": [np.int32(3),
                                                       torch.ones(2, dtype=torch.bfloat16)]}
    ck.save_checkpoint(str(tmp_path), 2, tree)
    assert _leaf_paths(tmp_path, 2) == ["['b']/[0]", "['b']/[1]", "['w']"]
    like = {"w": torch.zeros(2, 3), "b": [np.int32(0), torch.zeros(2, dtype=torch.bfloat16)]}
    got, at = ck.restore_checkpoint(str(tmp_path), like)
    assert at == 2 and got["w"] is like["w"] and torch.equal(got["w"], tree["w"])
    assert int(got["b"][0]) == 3 and torch.equal(got["b"][1], tree["b"][1])
    with pytest.raises(ValueError, match="shape"):
        ck.restore_checkpoint(str(tmp_path), {"w": torch.zeros(3, 2), "b": like["b"]})


def test_exact_resume_matches_an_uninterrupted_run(tmp_path):
    """Kill-and-restart reproduces the same trajectory: the restored
    state is bit-equal, so the resumed steps' losses and parameters are
    equal to the uninterrupted run's."""
    cfg = port_configs.get_config("stablelm-1.6b-smoke")
    src = SyntheticTokenSource(cfg.vocab_size, 16, 4, seed=1)
    step = M.make_train_step(cfg, learning_rate=1e-3)
    state = M.init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    for i in range(3):
        state, _ = step(state, to_port(src.batch(i)))
    ck.save_checkpoint(str(tmp_path), 3, state)
    losses = []
    for i in range(3, 5):
        state, m = step(state, to_port(src.batch(i)))
        losses.append(float(m["loss"]))
    like = M.init_train_state(torch.Generator().manual_seed(1), cfg, device="cpu")
    re, at = ck.restore_checkpoint(str(tmp_path), like)
    assert at == 3 and int(re.step) == 3
    resumed = []
    for i in range(3, 5):
        re, m = step(re, to_port(src.batch(i)))
        resumed.append(float(m["loss"]))
    assert resumed == losses
    for (n, p), q in zip(state.params.named_parameters(), re.params.parameters()):
        assert torch.equal(p, q), n
