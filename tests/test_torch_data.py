"""The port's data pipeline, kNN workload registry, straggler policy and
model-FLOP counts against the reference's, on the CPU.

Batches and vector datasets are bit-equal (both are numpy); the
registry's fields and ``cops_per_dot`` equal; ``KNNConfig.plan`` on the
port's ``"torch"`` backend at the ``a100`` profile equals the
reference's ``"xla"`` plan field for field, and the port's defaults are
the card's (``"h100"``, ``"cuda"``).  The new modules import neither JAX
nor ``repro``.
"""
import dataclasses
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import repro.configs as ref_configs
from repro.configs import knn_workloads as ref_knn
from repro.data import pipeline as ref_pipe
from repro.ft import straggler as ref_straggler
from repro.launch import dryrun as ref_dryrun
import repro_torch.configs as port_configs
from repro_torch.configs import knn_workloads as knn
from repro_torch.data import pipeline as pipe
from repro_torch.ft import straggler
from repro_torch.launch import dryrun

SOURCES = [
    dict(vocab_size=256, seq_len=16, global_batch=4),
    dict(vocab_size=92_544, seq_len=33, global_batch=6, seed=9, host_id=1,
         host_count=3),
    dict(vocab_size=256, seq_len=8, global_batch=2, input_mode="embeddings",
         d_model=24, mrope=True),
    dict(vocab_size=51_865, seq_len=12, global_batch=4, d_model=16,
         enc_seq=20, seed=4),
]


@pytest.mark.parametrize("kw", SOURCES, ids=["tokens", "hosts", "embeds-mrope",
                                             "enc-dec"])
def test_token_batches_bit_equal(kw):
    ours, ref = pipe.SyntheticTokenSource(**kw), ref_pipe.SyntheticTokenSource(**kw)
    assert ours.local_batch == ref.local_batch
    for step in (0, 1, 7, 1000):
        a, b = ours.batch(step), ref.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    it_a, it_b = iter(ours), iter(ref)
    for _ in range(3):
        x, y = next(it_a), next(it_b)
        assert all(np.array_equal(x[k], y[k]) for k in x)


def test_host_count_must_divide_the_batch():
    with pytest.raises(ValueError, match="not divisible"):
        pipe.SyntheticTokenSource(256, 8, 5, host_count=2)


def test_prefetcher_yields_the_steps_in_order():
    src = pipe.SyntheticTokenSource(256, 8, 2, seed=3)
    pf = pipe.Prefetcher(src, start_step=5)
    try:
        for want in range(5, 10):
            step, batch = pf.next()
            assert step == want
            np.testing.assert_array_equal(batch["tokens"], src.batch(want)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


@pytest.mark.parametrize("metric", ["mips", "l2", "cosine"])
def test_vector_datasets_bit_equal(metric):
    for n, d, seed in ((1000, 100, 0), (4097, 128, 3)):
        a = pipe.make_vector_dataset(n, d, seed=seed, metric=metric)
        b = ref_pipe.make_vector_dataset(n, d, seed=seed, metric=metric)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    a = pipe.make_vector_dataset(500, 8, clusters=3, seed=1)
    np.testing.assert_array_equal(
        a, ref_pipe.make_vector_dataset(500, 8, clusters=3, seed=1))


def test_registry_fields_equal_reference():
    assert sorted(knn.KNN_WORKLOADS) == sorted(ref_knn.KNN_WORKLOADS)
    for name, cfg in knn.KNN_WORKLOADS.items():
        ref = ref_knn.KNN_WORKLOADS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.cops_per_dot == ref.cops_per_dot
    for metric in ("l2", "cosine", "mips"):
        for flags in ((True, False), (False, True)):
            kw = dict(name="x", n=10, d=3, d_padded=128, m=2, metric=metric,
                      non_pow2_n=flags[0], broadcast_norm=flags[1])
            assert knn.KNNConfig(**kw).cops_per_dot == ref_knn.KNNConfig(**kw).cops_per_dot


@pytest.mark.parametrize("name", sorted(knn.KNN_WORKLOADS))
def test_registry_plans_equal_reference(name):
    """``plan(device="a100", backend="torch")`` is the reference's
    ``plan(device="a100", backend="xla")`` field for field, but the
    backend's name and the tiles (the port's are the CUDA kernels' fixed
    128 x 128, a ROADMAP divergence); the port's defaults plan the card's
    CUDA scan."""
    ours = knn.KNN_WORKLOADS[name].plan(device="a100", backend="torch")
    ref = ref_knn.KNN_WORKLOADS[name].plan(device="a100", backend="xla")
    for f in dataclasses.fields(ref):
        if f.name in ("backend", "block_m", "block_n"):
            continue
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert (ours.backend, ours.block_m, ours.block_n) == ("torch", 128, 128)
    card = knn.KNN_WORKLOADS[name].plan()
    assert (card.device, card.backend) == ("h100", "cuda")
    assert (card.num_bins, card.bin_size, card.k_scan) == (
        ours.num_bins, ours.bin_size, ours.k_scan)


def test_registry_stays_out_of_the_model_registry():
    assert sorted(port_configs.list_configs()) == sorted(ref_configs.list_configs())
    assert port_configs.KNN_WORKLOADS is knn.KNN_WORKLOADS
    assert port_configs.KNNConfig is knn.KNNConfig
    assert not any(n in port_configs.list_configs() for n in knn.KNN_WORKLOADS)


def test_straggler_policy_matches_reference():
    rng = np.random.default_rng(0)
    ours, ref = straggler.StragglerPolicy(), ref_straggler.StragglerPolicy()
    for step in range(40):
        times = {h: float(rng.uniform(0.9, 1.1)) for h in range(4)}
        if step >= 10:
            times[2] *= 2.5
        a, b = ours.observe(times), ref.observe(times)
        assert (a.kind, a.host, a.reason) == (b.kind, b.host, b.reason)
    assert a.kind == "swap" and a.host == 2


@pytest.mark.parametrize("shape", sorted(ref_configs.SHAPES))
def test_model_flops_and_ideal_bytes_equal_reference(shape):
    for arch in ref_configs.ASSIGNED_ARCHS:
        cfg, rcfg = port_configs.get_config(arch), ref_configs.get_config(arch)
        ps, rs = port_configs.SHAPES[shape], ref_configs.SHAPES[shape]
        assert dryrun.model_flops(cfg, ps) == ref_dryrun.model_flops(rcfg, rs)
        assert dryrun.ideal_memory_bytes(cfg, ps) == ref_dryrun.ideal_memory_bytes(rcfg, rs)


def test_new_modules_import_neither_jax_nor_repro():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.data.pipeline, repro_torch.configs.knn_workloads
        import repro_torch.optim.adamw, repro_torch.ft.straggler
        import repro_torch.models.model, repro_torch.models.params
        import repro_torch.checkpoint.checkpoint
        import repro_torch.launch.dryrun, repro_torch.launch.train
        from repro_torch.configs import KNN_WORKLOADS
        KNN_WORKLOADS["sift1m"].plan()
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
