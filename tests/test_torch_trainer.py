"""The port's trainer on the CPU: ``python -m repro_torch.launch.train``
and ``examples/torch_train_lm.py`` with a smoke config.  The loss falls
over 20 steps at lr 3e-3 (as ``tests/test_system.py::
test_train_loss_decreases`` shows for the reference: the mean of the
last five logged losses at least 0.2 below the first five's), a restart
resumes from the last checkpoint and reproduces the uninterrupted run's
losses, and ``--model-parallel`` > 1 runs on the host mesh as the
reference's trainer does."""
import importlib.util
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import train
from torch_train_parity import few_threads  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--arch", "internlm2-1.8b-smoke", "--seq", "32", "--global-batch", "8",
        "--lr", "3e-3", "--log-every", "1", "--device", "cpu"]


def _falls(losses):
    vals = [loss for _, loss in losses]
    assert all(np.isfinite(vals)), vals
    assert np.mean(vals[-5:]) < np.mean(vals[:5]) - 0.2, vals


def test_loss_falls_and_a_restart_resumes(tmp_path):
    d = str(tmp_path)
    out = train.main(ARGS + ["--steps", "20", "--ckpt-dir", d, "--ckpt-every", "10"])
    assert out["start"] == 0 and [s for s, _ in out["losses"]] == list(range(1, 21))
    _falls(out["losses"])
    assert sorted(os.listdir(d)) == ["step_00000010", "step_00000020"]
    # drop the last checkpoint: the restart resumes at step 10 and replays
    # steps 11..20 as the uninterrupted run did
    shutil.rmtree(os.path.join(d, "step_00000020"))
    again = train.main(ARGS + ["--steps", "20", "--ckpt-dir", d, "--ckpt-every", "10"])
    assert again["start"] == 10
    assert again["losses"] == out["losses"][10:]
    for p, q in zip(out["state"].params.parameters(), again["state"].params.parameters()):
        assert torch.equal(p, q)
    # a run that finds its last step committed has nothing to do
    done = train.main(ARGS + ["--steps", "20", "--ckpt-dir", d])
    assert done["start"] == 20 and done["final_loss"] is None


def _reference_losses(argv, capsys):
    """``repro.launch.train.main`` run as its CLI (on this process's one
    device: ``make_host_mesh(2)`` is its (1, 1) mesh), its logged losses
    read from what it prints."""
    from repro.launch import train as ref_train

    capsys.readouterr()
    old = sys.argv
    sys.argv = ["train"] + argv
    try:
        ref_train.main()
    finally:
        sys.argv = old
    return [float(x) for x in re.findall(r"loss=([0-9.]+) ", capsys.readouterr().out)]


def test_model_parallel_and_a_missing_card_are_refused(monkeypatch, capsys):
    """``--model-parallel 2`` runs on a (1, 1) host mesh of the CPU, as the
    reference's does on one device: the losses and the final state equal
    ``--model-parallel 1``'s bit for bit, and the reference's trainer with
    the same flags, from the same weights (the reference's, carried in),
    logs the same losses within the bf16 training tolerance (rtol 2e-2,
    ``tests/torch_train_parity.py::check_bf16_step``).  Without a card the
    default device is refused."""
    import jax

    from repro.models import model as ref_model
    from repro_torch.models import model as M
    from repro_torch.models import params

    flags = ["--steps", "4", "--seed", "3"]
    init = M.init_train_state

    def from_reference(generator, cfg, *, device=None):
        """The port's state holding the reference trainer's initial weights."""
        state = init(generator, cfg, device=device)
        ref = ref_model.init_train_state(jax.random.PRNGKey(3), cfg)
        with torch.no_grad():
            for name, t in params.from_reference(ref.params, cfg).items():
                state.params.get_parameter(name).copy_(t)
        return state
    monkeypatch.setattr(M, "init_train_state", from_reference)
    one = train.main(ARGS + flags + ["--model-parallel", "1"])
    two = train.main(ARGS + flags + ["--model-parallel", "2"])
    assert tuple(two["mesh"].shape.values()) == (1, 1)
    assert two["losses"] == one["losses"] and len(one["losses"]) == 4
    for p, q in zip(one["state"].params.parameters(), two["state"].params.parameters()):
        assert torch.equal(p, q)
    ref = _reference_losses(ARGS[:-2] + flags + ["--model-parallel", "2"], capsys)
    np.testing.assert_allclose([loss for _, loss in two["losses"]], ref, rtol=2e-2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(ARGS[:-2] + ["--steps", "1"])


def test_cli_runs_as_a_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS, "--steps", "3",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "[train] step=3 loss=" in out.stdout
    assert "done at step 3" in out.stdout
    assert os.path.exists(tmp_path / "step_00000003" / "META.json")


def test_example_trains_on_the_cpu(tmp_path):
    path = os.path.join(REPO, "examples", "torch_train_lm.py")
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--arch", "internlm2-1.8b-smoke",
                    "--steps", "20", "--seq", "32", "--lr", "3e-3",
                    "--log-every", "1", "--ckpt-dir", str(tmp_path)])
    _falls(out["losses"])
    assert os.path.exists(tmp_path / "step_00000020" / "META.json")
    # the example's own ~100M-parameter config (its default) is registered
    from repro_torch.configs import get_config

    assert get_config(mod.LM_100M.name) == mod.LM_100M
