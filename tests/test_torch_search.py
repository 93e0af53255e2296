"""repro_torch.search.Index against repro.search.Index(cluster="off").

The same numpy inputs go through both packages: the port's ``"torch"``
backend against the reference's ``"xla"``, and the port's ``"cuda"``
backend (its kernels' plain versions, on the CPU) against ``"pallas"``
in interpret mode.  Plans must be equal, values allclose and indices
equal up to near ties (``repro_torch.testing``), across add/delete
interleavings with capacity growth and up to 90% tombstones.
"""
import dataclasses
import math
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.search as ref_search
from repro.search.packed import snapshot_state
from repro_torch.search import (
    Index,
    SearchSpec,
    cuda_search_packed,
    dense_search,
    exact_search,
    state_from_arrays,
)
from repro_torch.testing import assert_topk_close, public_scorer

METRICS = ["mips", "l2", "cosine"]
# port backend -> the reference backend it is held against
PAIRS = {"torch": "xla", "cuda": "pallas"}


def _build_pair(db, backend, **kw):
    ours = Index.build(db, device="cpu", backend=backend, **kw)
    ref = ref_search.Index.build(jnp.asarray(db), backend=PAIRS[backend],
                                 cluster="off", **kw)
    return ours, ref


def _check(ours, ref, q, metric, rows):
    assert dataclasses.astuple(ours.plan) == dataclasses.astuple(ref.plan)
    assert ours.size == ref.size and ours.capacity == ref.capacity
    v, i = ours.search(q)
    rv, ri = ref.search(jnp.asarray(q))
    assert i.dtype == torch.int32 and v.shape == (q.shape[0], ours.spec.k)
    assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(), i.numpy(),
                      score=public_scorer(metric, q, rows))
    return i.numpy()


@pytest.mark.parametrize("backend", sorted(PAIRS))
@pytest.mark.parametrize("metric", METRICS)
def test_search_matches_reference(metric, backend):
    rng = np.random.default_rng(11)
    db = rng.standard_normal((1500, 100), dtype=np.float32)
    q = rng.standard_normal((37, 100), dtype=np.float32)
    ours, ref = _build_pair(db, backend, metric=metric, k=10, recall_target=0.95)
    assert ours.plan.bin_size == 8 and ours.expected_recall >= 0.95
    _check(ours, ref, q, metric, db)


@pytest.mark.parametrize("backend,metric,seed", [
    ("torch", "l2", 0), ("torch", "cosine", 1), ("torch", "mips", 2),
    ("cuda", "mips", 3), ("cuda", "l2", 4),
])
def test_add_delete_interleavings_match_reference(backend, metric, seed):
    """Seeded add/delete sequences: growth past capacity (bin re-plan),
    repeated delete ids, up to 90% tombstones.  No deleted id is ever
    returned, and every search matches the reference."""
    rng = np.random.default_rng(seed)
    d = 24
    rows = rng.standard_normal((800, d), dtype=np.float32)
    q = rng.standard_normal((16, d), dtype=np.float32)
    ours, ref = _build_pair(rows, backend, metric=metric, k=8,
                            recall_target=0.9, capacity=1000,
                            capacity_block=512)
    deleted = set()
    for step in range(6):
        if step % 2 == 0:
            new = rng.standard_normal((int(rng.integers(100, 700)), d),
                                      dtype=np.float32)
            rows = np.concatenate([rows, new])
            for index in (ours, ref):
                index.add(new)
        else:
            live = np.setdiff1d(np.arange(len(rows)), list(deleted))
            target = 0.9 if step == 5 else 0.4
            n_del = int(len(live) - (1 - target) * len(rows))
            ids = rng.choice(live, size=max(n_del, 1), replace=False)
            ids = np.concatenate([ids, ids[:3]])  # repeats count once
            deleted.update(ids.tolist())
            for index in (ours, ref):
                index.delete(ids)
        idx = _check(ours, ref, q, metric, rows)
        assert not deleted & set(idx[idx >= 0].tolist())
        assert ours.size == len(rows) - len(deleted)
    assert len(deleted) >= 0.89 * len(rows)
    assert ours.capacity > 1000  # grew, and re-planned its bins


@pytest.mark.parametrize("ref_backend", ["xla", "pallas"])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_state_from_reference_snapshot(metric, ref_backend):
    rng = np.random.default_rng(3)
    db = rng.standard_normal((1200, 40), dtype=np.float32)
    q = rng.standard_normal((9, 40), dtype=np.float32)
    ref = ref_search.Index.build(jnp.asarray(db), metric=metric, k=6,
                                 backend=ref_backend, cluster="off")
    ref.delete(jnp.arange(0, 1200, 4))
    arrays, meta = snapshot_state(ref._packed)
    arrays = {name: np.asarray(a) for name, a in arrays.items()}
    rv, ri = ref.search(jnp.asarray(q))
    score = public_scorer(metric, q, db)
    kw = dict(metric=metric, k=6, n=1200)
    for backend in ("torch", "cuda"):
        spec = SearchSpec(metric=metric, k=6, backend=backend)
        st = state_from_arrays(arrays, meta, spec, "cpu")
        assert dataclasses.astuple(st.plan) == dataclasses.astuple(ref.plan)
        if backend == "torch":
            v, i = dense_search(torch.from_numpy(q), st.db, st.bias,
                                metric=metric, k=6)
        else:
            v, i = cuda_search_packed(torch.from_numpy(q), st.db, st.bias,
                                      bin_size=st.bin_size, fused_select=True,
                                      **kw)
        assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(),
                          i.numpy(), score=score)
    with pytest.raises(ValueError, match="bin_size"):
        state_from_arrays(arrays, dict(meta, bin_size=meta["bin_size"] * 2),
                          SearchSpec(metric=metric, k=6), "cpu")


def _hoeffding_eps(n_samples, delta=1e-6):
    return math.sqrt(math.log(1.0 / delta) / (2.0 * n_samples))


@pytest.mark.parametrize("backend,metric,k,target", [
    ("torch", "mips", 10, 0.95),
    ("torch", "l2", 32, 0.90),
    ("cuda", "cosine", 4, 0.99),
    ("cuda", "l2", 16, 0.95),
])
def test_recall_meets_eq13_bound(backend, metric, k, target):
    """The check of tests/test_recall_guarantee.py on the port: mean
    recall over fresh draws stays above E[recall] minus the Hoeffding
    margin (delta = 1e-6), and is not trivially 1."""
    samples, expected = [], None
    for trial in range(4):
        rng = np.random.default_rng(100 + trial)
        db = rng.standard_normal((2048, 24), dtype=np.float32)
        q = rng.standard_normal((256, 24), dtype=np.float32)
        index = Index.build(db, metric=metric, k=k, recall_target=target,
                            backend=backend, device="cpu")
        assert index.expected_recall >= target
        expected = index.expected_recall
        _, approx = index.search(q)
        _, truth = exact_search(torch.from_numpy(q), torch.from_numpy(db), k,
                                metric=metric)
        for a, t in zip(approx.numpy(), truth.numpy()):
            samples.append(len(set(a.tolist()) & set(t.tolist())) / k)
    mean = float(np.mean(samples))
    assert mean >= expected - _hoeffding_eps(len(samples)), (mean, expected)
    assert mean < 1.0


def test_query_streaming_matches_one_block():
    rng = np.random.default_rng(8)
    db = rng.standard_normal((600, 16), dtype=np.float32)
    q = rng.standard_normal((50, 16), dtype=np.float32)
    for backend in ("torch", "cuda"):
        whole = Index.build(db, k=5, backend=backend, device="cpu")
        blocked = Index.build(db, k=5, backend=backend, device="cpu",
                              query_block=8)
        # BLAS may sum a smaller batch in another order: compare up to ties
        (v, i), (bv, bi) = whole.search(q), blocked.search(q)
        assert_topk_close(v.numpy(), i.numpy(), bv.numpy(), bi.numpy(),
                          score=public_scorer("mips", q, db))


def test_build_needs_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = np.eye(8, dtype=np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Index.build(db)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Index.build(db, device="cuda")
    assert Index.build(db, k=2, device="cpu").spec.backend == "auto"


# The IDs are given so that each case keeps its test ID when what it
# checks moves (a tile other than the kernels' 128 now names the fixed
# tile; the planner's "measure" is ported, so the sixth case is another
# field that is still outside the port; the bf16 compute dtype,
# cluster="auto" and serve_buckets are ported, so the first, third,
# fourth and eighth cases pair them with a field that is still outside
# it).
@pytest.mark.parametrize("kw,match", [
    (dict(storage="int8", cluster="auto", stream=False), "item 13"),
    (dict(residency="host"), "item 10"),
    (dict(dtype="bfloat16", serve_buckets=(8, 64), segment_rows=4096),
     "item 10"),
    (dict(cluster="auto", residency="host"), "item 10"),
    (dict(block_m=256), "fixed at 128x128"),
    (dict(storage="int8", residency="host"), "item 10"),
    (dict(stream=False), "item 13"),
    (dict(serve_buckets=(8, 64), stream=False), "item 13"),
    (dict(segment_rows=4096), "item 10"),
], ids=["kw0-item 7", "kw1-item 10", "kw2-item 6", "kw3-item 7",
        "kw4-item 5", "kw5-item 5", "kw6-item 13", "kw7-item 8",
        "kw8-item 10"])
def test_outside_the_slice_raises(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        Index.build(np.eye(8, dtype=np.float32), k=2, device="cpu", **kw)


def test_imports_neither_jax_nor_repro():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.kernels.partial_reduce
        import repro_torch.search.cluster
        from repro_torch.search import Index
        import repro_torch.core, repro_torch.testing
        idx = Index.build([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]], k=1,
                          device="cpu", backend="cuda")
        assert int(idx.search([[1.0, 2.0]]).indices[0, 0]) == 2
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
