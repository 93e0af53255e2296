"""Data parallelism across processes (ROADMAP item 14a) on the CPU.

Four ranks spawned over gloo (``tests/torch_dist_parity.py``) train each
case 3 steps on a (4, 1) ("data", "model") mesh, every rank on its row of
the global batch, against the reference's GSPMD step on 4 fake host
devices: internlm2 (dense), granite-moe (MoE, 64-token groups: seq 64, a
row a group), mamba2 (SSD) and qwen2-vl (embeddings input, M-RoPE) at
f32, the losses and grad norms within rtol 1e-5 and the parameters within
rtol 1e-5 / atol 1e-6; a label mask that differs across the ranks (the
global masked mean); and ``--grad-compression``.  Also: a world of one
process is bit-equal to today's single process, the refusals, and that
no ``repro_torch`` module imports JAX or ``repro``.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_dist_parity as P
from repro_torch.parallel import distributed as D

CASES = {
    "internlm2": P.case("internlm2-1.8b-smoke", "dp"),
    "granite_moe": P.case("granite-moe-3b-a800m-smoke", "dp", seq=64),
    "mamba2": P.case("mamba2-2.7b-smoke", "dp"),
    "qwen2_vl": P.case("qwen2-vl-2b-smoke", "dp"),
    "rank_mask": P.case("internlm2-1.8b-smoke", "dp", mask=True),
    "grad_compression": P.case("internlm2-1.8b-smoke", "dp", grad_dtype="bfloat16"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_dp"))
    ref = P.reference(CASES)
    return ref, P.port(CASES, ref, tmp)


@pytest.mark.parametrize("key", sorted(CASES))
def test_data_parallel_matches_reference(runs, key):
    ref, port = runs
    c = CASES[key]
    got, want = port[key], ref[key]
    assert got["tp"] == "None" and not got["split"] and not got["partial"]
    if c["grad_dtype"] is None:
        P.check(key, c, got, want)
        return
    # the compressed reduction: the port sums each rank's bf16-rounded
    # gradient in bf16, the reference rounds the f32 sum once, so the
    # gradients differ in bf16's last place
    np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=P.F32_RTOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=P.BF16_RTOL)


def test_rank_mask_differs_from_the_plain_case(runs):
    """The masked case's first loss is the global masked mean, not the
    mean of each rank's own: it differs from the unmasked case's and from
    the mean of the per-row means."""
    ref, port = runs
    assert port["rank_mask"]["losses"][0] != port["internlm2"]["losses"][0]


def test_no_port_module_imports_jax_or_repro():
    """Every module of ``repro_torch`` imports with ``jax`` and ``repro``
    blocked, and leaves neither in ``sys.modules``."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch
        names = sorted(m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch."))
        for name in names:
            importlib.import_module(name)
        assert "repro_torch.parallel.distributed" in names
        assert "repro_torch.parallel.tensor_parallel" in names
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH="src"))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 60


def test_refusals_without_a_process_group(monkeypatch):
    """A card that is missing, NCCL on the CPU and a run with neither a
    process group nor torchrun's environment raise; nothing falls back
    to the CPU or to one process."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            D.init_process_mesh(2, device="cuda")
    with pytest.raises(ValueError, match="gloo"):
        D.init_process_mesh(2, device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="torchrun"):
        D.init_process_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        from repro_torch.launch import train

        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("LOCAL_RANK", "1")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--arch", "internlm2-1.8b-smoke", "--steps", "1"])


def test_local_rows_follow_the_reference_batch_sharding():
    """Each data rank takes its contiguous part of the batch, in the
    reference's order; model ranks take the same rows."""
    class Grid:
        def __init__(self, dp, d):
            self.dp, self.d = dp, d

        def axis_size(self, axes):
            return self.dp

        def axis_index(self, axis):
            return self.d

    rows = [D.local_rows(8, Grid(2, d)).tolist() for d in range(2)]
    assert rows == [[0, 1, 2, 3], [4, 5, 6, 7]]
    rows = [D.local_rows(8, Grid(4, d)).tolist() for d in range(4)]
    assert rows == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="data ranks"):
        D.local_rows(6, Grid(4, 0))
    batch = {"labels": np.arange(8)[:, None], "mrope_positions": np.zeros((3, 5))}
    part = D.local_batch(batch, Grid(4, 3))
    assert part["labels"].ravel().tolist() == [6, 7]
    assert part["mrope_positions"].shape == (3, 5)
