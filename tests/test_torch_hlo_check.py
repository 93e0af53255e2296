"""The planner's FLOP cross-check, ``explain(validate_hlo=True)``.

The counterpart of ``tests/test_plan.py``'s HLO self-audit: the port
counts the ops of one search without running it
(``repro_torch.analysis.op_cost``, under a fake-tensor mode) and
``plan.hlo_check`` sets them beside the plan's.  On the ``"torch"`` path
the counted dot FLOPs are exactly the model's, as XLA's are on the
reference's ``"xla"`` path, and the two ratios are equal; on the
``"cuda"`` path (counted on the CPU through the kernels' plain version
at the kernels' operands) the model's scan carries the passes of the
exact bf16 split, which the report names as ``split_passes``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.search import Index as RefIndex
from repro_torch.analysis.op_cost import search_cost
from repro_torch.core.binning import round_up
from repro_torch.search import Index, hlo_check

M, N, D, K = 64, 512, 40, 5


def _db(n=N, d=D, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d), dtype=np.float32)


def test_explain_measure_and_hlo_crosscheck():
    index = Index.build(_db(), k=K, backend="torch", device="cpu",
                        cluster="off")
    report = index.explain(m=M, measure=True, validate_hlo=True)
    meas = report["measured"]
    assert meas["wall_s"] > 0 and meas["qps"] > 0
    hlo = report["hlo"]
    assert hlo["hlo_dot_flops"] == 2 * M * N * D
    assert hlo["flops_ratio"] == pytest.approx(1.0)
    assert hlo["split_passes"] == 1
    lo, hi = hlo["hlo_hbm_bytes_bounds"]
    assert 0 < lo <= hlo["hlo_hbm_bytes"] <= hi
    assert hlo["hlo_cop_count"] > 0


@pytest.mark.parametrize("storage", ["f32", "int8", "int4"])
@pytest.mark.parametrize("metric", ["mips", "l2"])
def test_ratio_equals_reference(metric, storage):
    db = _db()
    kw = dict(metric=metric, k=K, storage=storage, cluster="off")
    ours = Index.build(db, backend="torch", device="cpu", **kw)
    ref = RefIndex.build(jnp.asarray(db), backend="xla", **kw)
    mine = ours.explain(m=M, validate_hlo=True)["hlo"]
    theirs = ref.explain(m=M, validate_hlo=True)["hlo"]
    assert mine["model_flops"] == theirs["model_flops"]
    assert mine["hlo_dot_flops"] == theirs["hlo_dot_flops"]
    assert mine["flops_ratio"] == pytest.approx(theirs["flops_ratio"])
    assert sorted(set(theirs) - set(mine)) == []


@pytest.mark.parametrize("dtype,storage,passes", [
    (None, "f32", 6), (None, "int8", 3), (None, "int4", 3),
    ("bfloat16", "f32", 1), ("bfloat16", "int8", 1),
])
def test_cuda_path_counts_the_kernel_at_its_operands(dtype, storage, passes):
    db = _db()
    ix = Index.build(db, k=K, storage=storage, dtype=dtype, cluster="off",
                     backend="cuda", device="cpu")
    hlo = ix.explain(m=M, validate_hlo=True)["hlo"]
    n_pad = ix.pack().db.shape[0]
    scan = 2 * M * n_pad * round_up(D, 16)
    rescore = 2 * M * ix.k_scan * D if storage != "f32" else 0
    assert hlo["split_passes"] == passes
    assert hlo["hlo_dot_flops"] == scan + rescore
    assert hlo["flops_ratio"] == pytest.approx(1.0)


def test_hlo_check_takes_any_cost():
    ix = Index.build(_db(), k=K, backend="torch", device="cpu",
                     cluster="off")
    plan = ix._replan(n=ix.capacity, m=16, pin_from=ix.kernel_plan)
    report = hlo_check(plan, search_cost(ix, 16))
    assert report["hlo_dot_flops"] == 2 * 16 * N * D
    assert report["flops_ratio"] == pytest.approx(1.0)


def test_counting_allocates_nothing_and_runs_no_kernel():
    from repro_torch.kernels import partial_reduce as prk

    ix = Index.build(_db(n=1 << 16), k=K, backend="cuda", device="cpu",
                     cluster="off")
    prk.reset_counts()
    cost = search_cost(ix, 10_000)  # a (10000, 65536) score tile: never made
    assert cost.kernel_dot_flops == 2 * 10_000 * (1 << 16) * 48
    assert not prk.PLAIN_CALLS and not prk.LAUNCHES
