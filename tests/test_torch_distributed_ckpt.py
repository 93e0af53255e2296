"""The trainer and its checkpoints across processes (ROADMAP item 14a).

``repro_torch.launch.train.main`` in ranks spawned over gloo
(``tests/torch_dist_parity.py``), with internlm2-1.8b-smoke as shipped:
a world of one process is bit-equal to the single-process trainer; a run
on a (2, 2) mesh checkpoints (rank 0 writes the gathered state in the
reference's format), a restart on (2, 2) replays the last step bit for
bit, one on (4, 1) restores the same values bit for bit and steps on; the
reference's ``restore_checkpoint`` reads the checkpoint as the gathered
state; ``torchrun`` runs the trainer as its command; and every case
without a path across processes (serving a shard) raises under a process
mesh.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import torch

import torch_dist_parity as P
from repro.checkpoint import checkpoint as ref_ck
from repro.models import model as ref_model
import repro.configs as ref_configs
from repro_torch.launch import train

from torch_train_parity import few_threads  # noqa: F401 (a fixture)

ARCH = "internlm2-1.8b-smoke"
ARGS = ["--arch", ARCH, "--seq", "32", "--global-batch", "4", "--lr", "3e-3",
        "--log-every", "1", "--device", "cpu"]


def _run(argv):
    out = train.main(ARGS + argv)
    return dict(losses=out["losses"], grad_norms=out["grad_norms"],
                mesh=tuple(out["mesh"].shape.values()),
                state=P.state_numpy(out["state"]),
                step=int(out["state"].step), start=out["start"])


def _world_of_one(rank, payload):
    return _run(["--steps", "3"])


def test_world_of_one_is_bit_equal_to_the_single_process(tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    one = _run(["--steps", "3"])
    proc = P.spawn(1, _world_of_one, None, str(tmp_path))
    assert proc["mesh"] == (1, 1) and one["mesh"] == (1, 1)
    assert proc["losses"] == one["losses"] and len(one["losses"]) == 3
    assert proc["grad_norms"] == one["grad_norms"]
    assert proc["state"].keys() == one["state"].keys()
    for k, v in one["state"].items():
        assert np.array_equal(proc["state"][k], v), k


def _meshes(rank, root):
    """A on (2, 2) to step 3, checkpoints at 2 and 3; B resumes a copy
    without step 3 on (2, 2), C on (4, 1), after C's restore is held to
    the step-2 arrays."""
    import torch.distributed as dist

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch import shardspecs as SS
    from repro_torch.models import model as M
    from repro_torch.parallel import distributed as D
    from repro_torch.parallel.sharding import place, use_mesh

    a_dir, b_dir, c_dir = (os.path.join(root, x) for x in "abc")
    flags = ["--steps", "3", "--ckpt-every", "2"]
    a = _run(flags + ["--model-parallel", "2", "--ckpt-dir", a_dir])
    if rank == 0:
        for d in (b_dir, c_dir):
            shutil.copytree(a_dir, d)
            shutil.rmtree(os.path.join(d, "step_00000003"))
    dist.barrier()
    b = _run(flags + ["--model-parallel", "2", "--ckpt-dir", b_dir])
    # the (4, 1) restore of the step-2 checkpoint, gathered
    pm = D.init_process_mesh(1, device="cpu")
    cfg = get_config(ARCH)
    with use_mesh(pm):
        sh = SS.train_state_specs(cfg, pm)
        like = place(M.init_train_state(torch.Generator().manual_seed(9), cfg,
                                        device="cpu"), sh)
        restored, at = restore_checkpoint(c_dir, like, shardings=sh)
    restored_c = dict(at=at, state=P.state_numpy(restored), step=int(restored.step))
    c = _run(flags + ["--model-parallel", "1", "--ckpt-dir", c_dir])
    return dict(a=a, b=b, c=c, restored_c=restored_c)


def test_checkpoints_resume_across_meshes(tmp_path):
    root = str(tmp_path)
    out = P.spawn(4, _meshes, root, root)
    a, b, c = out["a"], out["b"], out["c"]
    assert a["mesh"] == (2, 2) and b["mesh"] == (2, 2) and c["mesh"] == (4, 1)
    assert a["start"] == 0 and b["start"] == 2 and c["start"] == 2
    # (2, 2) -> (2, 2): the last step replayed bit for bit
    assert b["losses"] == a["losses"][2:] and b["grad_norms"] == a["grad_norms"][2:]
    for k, v in a["state"].items():
        assert np.array_equal(b["state"][k], v), k
    # (2, 2) -> (4, 1): the step-2 values restored bit for bit, then a step
    # on the other mesh (bf16 compute: check_bf16_step's tolerance)
    restored = out["restored_c"]
    assert restored["at"] == 2 and restored["step"] == 2
    want = P.saved_state(os.path.join(root, "a"), 2, ARCH)
    assert want.keys() == restored["state"].keys()
    for k, v in want.items():
        assert np.array_equal(restored["state"][k], v), k
    np.testing.assert_allclose([x for _, x in c["losses"]],
                               [x for _, x in a["losses"][2:]], rtol=P.BF16_RTOL)
    # the reference reads the (2, 2) run's last checkpoint as its state
    at, got = P.reference_checkpoint(os.path.join(root, "a"), ARCH)
    assert at == 3
    assert got.keys() == a["state"].keys()
    for k, v in a["state"].items():
        assert np.array_equal(got[k], v), k


def test_torchrun_runs_the_trainer(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train
    --model-parallel 2 --device cpu``: gloo on the CPU, a (1, 2) mesh,
    rank 0 alone logs and writes the report."""
    report = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *ARGS,
         "--steps", "2", "--model-parallel", "2", "--report", str(report)],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("[train] step=2 loss=") == 1, out.stdout
    rep = json.loads(report.read_text())
    assert rep["mesh"] == {"data": 1, "model": 2} and rep["world"] == 2
    assert rep["backend"] == "gloo" and len(rep["losses"]) == 2
    assert not rep["launches"] and not rep["plain_calls"]
    assert all(np.isfinite(x) for _, x in rep["losses"] + rep["grad_norms"])


def _refusals(rank, payload):
    """Each case the port has no path for, on a (2, 2) process mesh of the
    CPU (or (4, 1), (1, 4)): the exception's type and message, or for a
    case that places, the local shapes of its parameters."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import shardspecs as SS
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import distributed as D
    from repro_torch.parallel.sharding import place, use_mesh

    def attempt(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 (the refusal is the result)
            return type(e).__name__, str(e)
        return None

    def init(cfg, pm):
        with use_mesh(pm):
            return place(M.init_train_state(torch.Generator().manual_seed(0),
                                            cfg, device="cpu"),
                         SS.train_state_specs(cfg, pm))

    def shapes(state):
        return {n: tuple(p.shape) for n, p in state.params.named_parameters()}

    out = {}
    tp = D.init_process_mesh(2, device="cpu")
    # the dense layer's other inputs (item 14b.2a), MoE and MLA (14b.2b),
    # the SSD, RG-LRU and local attention (14b.2c) have a path: they place
    for arch in ("whisper-medium-smoke", "qwen2-vl-2b-smoke"):
        out[arch] = shapes(init(get_config(arch), tp))
    for arch in ("granite-moe-3b-a800m-smoke", "deepseek-v2-236b-smoke",
                 "mamba2-2.7b-smoke", "recurrentgemma-9b-smoke"):
        out[arch] = shapes(init(get_config(arch), tp))
        out[f"{arch}+fsdp"] = shapes(init(dataclasses.replace(
            get_config(arch), fsdp_params=True), tp))
    dense = init(get_config("internlm2-1.8b-smoke"), tp)
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    out["prefill"] = attempt(lambda: tfm.forward_prefill(dense.params, tokens))
    dp = D.init_process_mesh(1, device="cpu")
    fsdp = dataclasses.replace(get_config("granite-20b-smoke"), fsdp_params=True)
    zero3 = init(fsdp, dp)
    out["fsdp"] = (tuple(dp.shape.values()), shapes(zero3))
    out["prefill_zero3"] = attempt(lambda: tfm.forward_prefill(zero3.params, tokens))
    out["fsdp_model_only"] = attempt(lambda: init(fsdp, D.init_process_mesh(
        4, device="cpu")))
    return out


def test_cases_without_a_path_raise(tmp_path):
    """Serving a shard (tensor-parallel or ZeRO-3) raises on a (2, 2)
    mesh; nothing runs whole on one rank instead (re-meshing a shard has
    a path: ``test_torch_distributed_remesh.py``).  Every
    family places on (2, 2), with and without ``fsdp_params``: whisper,
    embeddings input (qwen2-vl), MoE (granite-moe) and MLA (deepseek-v2)
    with heads and experts halved, the MoE router and MLA's ``wkv_a``
    whole over "model"; the SSD (mamba2) and RG-LRU with local attention
    (recurrentgemma) at the contiguous cut of the sanitized spec, the one
    kv head whole (their parity is
    ``test_torch_distributed_tp_{inputs,moe,recurrent}.py``'s).
    granite-20b with ``fsdp_params`` on (4, 1) places (ZeRO-3: every
    parameter's embed dim a quarter), and on (1, 4), a data axis of 1,
    places too (the split drops)."""
    out = P.spawn(4, _refusals, None, str(tmp_path))
    for key in ("prefill", "prefill_zero3"):
        assert out[key] is not None, key
        kind, msg = out[key]
        assert kind == "NotImplementedError", (key, kind, msg)
    # the SSD's and RG-LRU's leaves cut contiguously over "model" (2),
    # the embed dim over "data" (2) with fsdp_params
    for fsdp, dp in (("", 1), ("+fsdp", 2)):
        ssm = out[f"mamba2-2.7b-smoke{fsdp}"]
        assert ssm["layers.0.ssm.in_proj"] == (64 // dp, 148)
        assert ssm["layers.0.ssm.conv_w"] == (4, 80)
        assert ssm["layers.1.ssm.out_proj"] == (64, 64 // dp)
        assert ssm["layers.1.ssm.dt_bias"] == (4,)
        rg = out[f"recurrentgemma-9b-smoke{fsdp}"]
        assert rg["layers.0.rglru.w_input_gate"] == (32, 64)
        assert rg["layers.1.rglru.wx"] == (64 // dp, 32)
        assert rg["layers.3.rglru.wo"] == (32, 64 // dp)
        assert rg["layers.2.attn.wq"] == (64 // dp, 2, 16)
        assert rg["layers.2.attn.wk"] == (64 // dp, 1, 16)
        assert rg["layers.4.mlp.wi"] == (64 // dp, 64)
    # experts and heads over "model" (2), the embed dim over "data" (2)
    # with fsdp_params; the router and wkv_a cut over "data" only
    for fsdp, dp in (("", 1), ("+fsdp", 2)):
        moe = out[f"granite-moe-3b-a800m-smoke{fsdp}"]
        assert moe["layers.1.moe.wi"] == (4, 64 // dp, 32)
        assert moe["layers.1.moe.wo"] == (4, 32, 64 // dp)
        assert moe["layers.1.attn.wq"] == (64 // dp, 2, 16)
        assert moe["layers.1.moe.router"] == (64 // dp, 8)
        mla = out[f"deepseek-v2-236b-smoke{fsdp}"]
        assert mla["layers.0.attn.wq_b"] == (48, 2, 24)
        assert mla["layers.0.attn.wk_b"] == (32, 2, 16)
        assert mla["layers.2.attn.wo"] == (2, 16, 64 // dp)
        assert mla["layers.2.moe.wg"] == (4, 64 // dp, 32)
        assert mla["layers.2.moe.shared_wo"] == (16, 64 // dp)
        assert mla["layers.2.moe.router"] == (64 // dp, 8)
        assert mla["layers.1.attn.wkv_a"] == (64 // dp, 40)
        assert mla["layers.1.attn.kv_norm"] == (32,)
    whisper, qwen = out["whisper-medium-smoke"], out["qwen2-vl-2b-smoke"]
    assert whisper["encoder.0.attn.wq"] == (64, 2, 16)
    assert whisper["layers.1.cross.wk"] == (64, 2, 16)
    assert whisper["encoder.1.mlp.wi"] == (64, 64)
    assert whisper["enc_final_norm"] == (64,)
    assert qwen["layers.0.attn.wk"] == (64, 1, 16)
    assert qwen["embed.embedding"] == (128, 64)
    assert "ZeRO-3" in out["prefill_zero3"][1]
    mesh, shapes = out["fsdp"]
    assert mesh == (4, 1)
    assert shapes["embed.embedding"] == (256, 16)
    assert shapes["layers.0.attn.wq"] == (16, 4, 16)
    assert shapes["layers.1.mlp.wo"] == (128, 16)
    assert shapes["final_norm"] == (16,)
    assert out["fsdp_model_only"] is None


# -- ZeRO-3 checkpoints -----------------------------------------------------------

ZERO3_ARCH = "granite-20b-smoke-zero3"  # granite-20b-smoke, fsdp_params, f32
ZERO3_ARGS = ["--arch", ZERO3_ARCH, "--seq", "32", "--global-batch", "4",
              "--lr", "3e-3", "--log-every", "1", "--device", "cpu",
              "--steps", "2", "--ckpt-every", "1"]


def _register_zero3():
    import dataclasses

    from repro_torch.configs import get_config, register

    register(dataclasses.replace(get_config("granite-20b-smoke"), name=ZERO3_ARCH,
                                 fsdp_params=True, dtype="float32"))


def _zero3_meshes(rank, root):
    """A: ZeRO-3 on (4, 1), 2 steps, checkpoints at 1 and 2.  The
    single process's step-1 checkpoint (``single``) restored as ZeRO-3
    (4, 1) shards, gathered; B resumes a copy of A without step 2 on
    (2, 2) (ZeRO-3 with tensor parallelism), its restored state
    gathered too."""
    import torch.distributed as dist

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch import shardspecs as SS
    from repro_torch.models import model as M
    from repro_torch.parallel import distributed as D
    from repro_torch.parallel.sharding import use_mesh

    _register_zero3()
    a_dir, b_dir, c_dir = (os.path.join(root, x) for x in "abc")

    def restored(directory, model_parallel):
        pm = D.init_process_mesh(model_parallel, device="cpu")
        cfg = get_config(ZERO3_ARCH)
        with use_mesh(pm):
            sh = SS.train_state_specs(cfg, pm)
            like = M.init_train_state(torch.Generator().manual_seed(9), cfg,
                                      shardings=sh)
            state, at = restore_checkpoint(directory, like, step=1, shardings=sh)
        layout = state.params.layout
        return dict(at=at, state=P.state_numpy(state), mesh=tuple(pm.shape.values()),
                    data_split=len(layout.data_split))

    from_single = restored(os.path.join(root, "single"), 1)
    a = train.main(ZERO3_ARGS + ["--ckpt-dir", a_dir])
    a = dict(losses=a["losses"], grad_norms=a["grad_norms"],
             mesh=tuple(a["mesh"].shape.values()), state=P.state_numpy(a["state"]),
             data_split=len(a["state"].params.layout.data_split))
    if rank == 0:
        for d in (b_dir, c_dir):
            shutil.copytree(a_dir, d)
            shutil.rmtree(os.path.join(d, "step_00000002"))
    dist.barrier()
    on_22 = restored(b_dir, 2)
    b = train.main(ZERO3_ARGS + ["--model-parallel", "2", "--ckpt-dir", b_dir])
    b = dict(losses=b["losses"], grad_norms=b["grad_norms"], start=b["start"],
             mesh=tuple(b["mesh"].shape.values()))
    return dict(a=a, b=b, on_22=on_22, from_single=from_single)


def _saved(directory, step):
    return P.saved_state(directory, step, ZERO3_ARCH)


def _reference_step(directory, step):
    """The reference's trainer step ``step + 1`` from the checkpoint of
    ``step``: its loss and grad norm, with the port trainer's schedule and
    batch."""
    import dataclasses

    import jax.numpy as jnp

    from repro.data.pipeline import SyntheticTokenSource
    from repro.optim.adamw import cosine_schedule

    cfg = dataclasses.replace(ref_configs.get_config("granite-20b-smoke"),
                              fsdp_params=True, dtype="float32")
    like = jax.eval_shape(lambda: ref_model.init_train_state(
        jax.random.PRNGKey(0), cfg))
    state, at = ref_ck.restore_checkpoint(directory, like, step=step)
    fn = jax.jit(ref_model.make_train_step(
        cfg, learning_rate=cosine_schedule(3e-3, 20, 2)))
    batch = SyntheticTokenSource(cfg.vocab_size, 32, 4, seed=0).batch(at)
    _, m = fn(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(m["loss"]), float(m["grad_norm"])


def test_zero3_checkpoints_cross_meshes_and_the_single_process(tmp_path, monkeypatch):
    """A ZeRO-3 (4, 1) run of granite-20b-smoke (f32) checkpoints in the
    reference's format; its step-1 checkpoint restores bit for bit on
    (2, 2) and in a single process, and each resumes step 2 within rtol
    1e-5 of the (4, 1) run's and of the reference's step from the same
    checkpoint.  A single process's checkpoint restores as ZeRO-3 (4, 1)
    shards bit for bit."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    root = str(tmp_path)
    _register_zero3()
    single_dir = os.path.join(root, "single")
    single = train.main(ZERO3_ARGS + ["--steps", "1", "--ckpt-dir", single_dir])
    assert single["mesh"].shape["data"] == 1 and single["state"].params.layout is None
    out = P.spawn(4, _zero3_meshes, root, root)
    a, b = out["a"], out["b"]
    assert a["mesh"] == (4, 1) and b["mesh"] == (2, 2) and b["start"] == 1
    assert a["data_split"] > 0
    # restored bit for bit: the single process's checkpoint as (4, 1) shards,
    # A's on (2, 2) and in this process
    for got, directory in ((out["from_single"], single_dir),
                           (out["on_22"], os.path.join(root, "b"))):
        assert got["at"] == 1 and got["data_split"] > 0
        want = _saved(directory, 1)
        assert want.keys() == got["state"].keys()
        for k, v in want.items():
            assert np.array_equal(got["state"][k], v), k
    cfg = get_config(ZERO3_ARCH)
    like = M.init_train_state(torch.Generator().manual_seed(9), cfg, device="cpu")
    state, at = restore_checkpoint(os.path.join(root, "c"), like)
    here = P.state_numpy(state)
    for k, v in _saved(os.path.join(root, "c"), 1).items():
        assert np.array_equal(here[k], v), k
    c = train.main(ZERO3_ARGS + ["--ckpt-dir", os.path.join(root, "c")])
    assert c["start"] == 1 and c["state"].params.layout is None
    # step 2 resumed on (2, 2) and in one process, against (4, 1)'s and
    # the reference's step from the step-1 checkpoint
    loss, gnorm = _reference_step(os.path.join(root, "c"), 1)
    for run in (b, c):
        (step, got_loss), = run["losses"]
        (_, got_norm), = run["grad_norms"]
        assert step == 2
        np.testing.assert_allclose(got_loss, a["losses"][1][1], rtol=P.F32_RTOL)
        np.testing.assert_allclose(got_norm, a["grad_norms"][1][1], rtol=P.F32_RTOL)
        np.testing.assert_allclose(got_loss, loss, rtol=P.F32_RTOL)
        np.testing.assert_allclose(got_norm, gnorm, rtol=P.F32_RTOL)
