"""The port's cluster pruning against the reference's, on the CPU.

``repro_torch.search.cluster`` and its hooks (``plan.plan_clusters``,
``backends.cluster_search_quant``, ``packed``'s side tables, the lazy
recluster in ``Index.add``) against ``repro.search``'s, on mixture corpora
drawn as ``tests/test_cluster.py`` draws them (64 components, centers
N(0, 1) x 2.5, unit noise, queries from the same centers).  Neither side
draws random numbers (strided k-means init, strided miss samples), so the
closed forms and plans are equal exactly, the slot tables and spill
blocks are equal, and the centroids agree to the order of their f32 sums
(rtol 1e-5).  Searches are compared with rtol/atol 1e-5 through the
near-tie rule of ``repro_torch.testing``; the port's ``"torch"`` backend
is held to ``"xla"`` and its ``"cuda"`` backend (plain versions on the
CPU) to ``"pallas"``: both references run the same gathered program.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.search as ref_search
from repro.search import cluster as ref_cluster
from repro.search import plan as ref_plan
from repro.search.packed import PACK_EVENTS as REF_EVENTS
from repro.search.packed import snapshot_state
from repro_torch.search import Index, exact_search, get_metric
from repro_torch.search import backends, cluster, packed
from repro_torch.search import plan as planlib
from repro_torch.search.spec import SearchSpec
from repro_torch.testing import assert_topk_close, public_scorer

N, D, K, COMPONENTS = 8192, 32, 10, 64
METRICS = ["mips", "l2", "cosine"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _mixture(seed, n=N, m=64, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(COMPONENTS, d)) * 2.5
    db = centers[rng.integers(0, COMPONENTS, n)] + rng.normal(size=(n, d))
    q = centers[rng.integers(0, COMPONENTS, m)] + rng.normal(size=(m, d))
    return db.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _mixture(0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# --- closed forms and the planner ------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 100, 2048, 8192, 16384, 65536,
                               1_000_000, 1_183_514])
def test_closed_forms_equal_reference(n):
    for target in (0.5, 0.9, 0.95, 0.99):
        assert cluster.miss_budget_for(target) == ref_cluster.miss_budget_for(target)
        assert cluster.miss_check_threshold(
            cluster.miss_budget_for(target)) == ref_cluster.miss_check_threshold(
            ref_cluster.miss_budget_for(target))
        c = cluster.num_clusters_for(n)
        assert c == ref_cluster.num_clusters_for(n)
        assert cluster.probes_for(target, c) == ref_cluster.probes_for(target, c)
        assert cluster.spill_capacity_for(n) == ref_cluster.spill_capacity_for(n)
        assert (cluster.rows_per_cluster_for(n, c)
                == ref_cluster.rows_per_cluster_for(n, c))
        for k_scan in (1, 10, 30, 200):
            ours = planlib.plan_clusters(n=n, k_scan=k_scan, recall_target=target)
            ref = ref_plan.plan_clusters(n=n, k_scan=k_scan, recall_target=target)
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
            assert ours.scan_rows == ref.scan_rows
            if n > 1:
                assert (ours.recall_decomposition(k_scan)
                        == ref.recall_decomposition(k_scan))


def test_sift1m_plan():
    """The Sift1M shape's plan (N=1,000,000, k=10, target 0.95)."""
    cp = planlib.plan_clusters(n=1_000_000, k_scan=10, recall_target=0.95)
    assert (cp.num_clusters, cp.rows_per_cluster, cp.probes,
            cp.spill_capacity, cp.scan_rows) == (1024, 1224, 32, 15632, 54800)
    assert cp.enabled and round(cp.predicted_speedup, 2) == 4.54
    assert round(cp.target_scan, 4) == 0.9744


@pytest.mark.parametrize("n,storage,m", [
    (8192, "f32", 64), (8192, "int8", 16), (100_000, "int4", 256),
    (1_000_000, "f32", 10_000), (2048, "f32", 32),
])
def test_plan_search_cluster_equals_reference(n, storage, m):
    """``plan_search(cluster="auto")`` on the plain backend: the cluster
    plan, the pruned scan's cost and the product guarantee are the
    reference's ``"xla"`` plan's."""
    kw = dict(n=n, d=D, k=K, m=m, metric="l2", recall_target=0.95,
              storage=storage, cluster="auto", device="a100")
    ours = planlib.plan_search(backend="torch", **kw)
    ref = ref_plan.plan_search(backend="xla", **kw)
    assert dataclasses.asdict(ours.cluster) == dataclasses.asdict(ref.cluster)
    for field in ("expected_recall", "flops", "hbm_bytes", "cops",
                  "predicted_s", "bottleneck", "num_bins", "k_scan"):
        assert getattr(ours, field) == getattr(ref, field), field
    off = planlib.plan_search(backend="torch", **dict(kw, cluster="off"))
    assert off.cluster is None
    cache = planlib.PlanCache()
    assert (cache.key(ours).endswith("/cl")) == ours.cluster.enabled
    # the card's profile evaluates the same cluster plan, and drops it
    # where it prices the pruned scan at least as high as the dense one
    h100 = planlib.plan_search(backend="cuda", **dict(kw, device="h100"))
    assert dataclasses.replace(h100.cluster, enabled=ours.cluster.enabled) \
        == ours.cluster
    if h100.cluster_veto is not None:
        pruned_s, dense_s = h100.cluster_veto
        assert ours.cluster.enabled and not h100.cluster.enabled
        assert pruned_s >= dense_s
        dense = planlib.plan_search(backend="cuda",
                                    **dict(kw, device="h100", cluster="off"))
        assert (h100.flops, h100.predicted_s) == (dense.flops, dense.predicted_s)
        assert dense_s == dense.predicted_s
    else:
        assert h100.cluster.enabled == ours.cluster.enabled
        if ours.cluster.enabled:
            assert h100.flops == ours.flops


# --- k-means, the tables, the miss check --------------------------------------


@pytest.mark.parametrize("metric", METRICS)
def test_tables_equal_reference(data, metric):
    """kmeans, build_tables and sampled_miss_rate on the same prepared
    rows: centroids allclose, the slot tables, fill counts and spill
    block equal, the same miss rate."""
    db, _ = data
    live = np.ones((N,), bool)
    live[::7] = False
    plan = planlib.plan_clusters(n=N, k_scan=K, recall_target=0.95)
    assert plan.enabled
    ours_m, ref_m = get_metric(metric), ref_search.get_metric(metric)
    rows, bias = ours_m.prepare_database(torch.from_numpy(db))
    ref_rows, ref_bias = ref_m.prepare_database(jnp.asarray(db))
    np.testing.assert_allclose(rows.numpy(), np.asarray(ref_rows), **TOL)
    ref_rows_t = _t(ref_rows)  # the same rows on both sides from here on
    np.testing.assert_allclose(
        cluster.kmeans(ref_rows_t[live], 128).numpy(),
        np.asarray(ref_cluster.kmeans(ref_rows[np.flatnonzero(live)], 128)),
        rtol=1e-5, atol=1e-5)
    ours = cluster.build_tables(ref_rows_t, torch.from_numpy(live), plan,
                                ours_m.prepare_database)
    ref = ref_cluster.build_tables(ref_rows, live, plan, ref_m.prepare_database)
    np.testing.assert_allclose(ours.centroids.numpy(), np.asarray(ref.centroids),
                               **TOL)
    np.testing.assert_allclose(ours.centroid_bias.numpy(),
                               np.asarray(ref.centroid_bias), **TOL)
    np.testing.assert_array_equal(ours.cluster_rows.numpy(),
                                  np.asarray(ref.cluster_rows))
    np.testing.assert_array_equal(ours.spill_rows.numpy(), np.asarray(ref.spill_rows))
    np.testing.assert_array_equal(ours.counts, np.asarray(ref.counts))
    assert ours.spill_count == ref.spill_count == ours.spill_baseline
    fused = packed.fuse_bias(None if ref_bias is None else _t(ref_bias),
                             torch.from_numpy(live))
    ref_fused = ref_search.packed.fuse_bias(ref_bias, jnp.asarray(live))
    miss = cluster.sampled_miss_rate(ours, ref_rows_t, fused, live, K)
    assert miss == ref_cluster.sampled_miss_rate(ref, ref_rows, ref_fused,
                                                 live, K)
    assert miss <= cluster.miss_check_threshold(plan.miss_budget)
    # the reference's tables through snapshot_tables -> restore_tables
    arrays, meta = ref_cluster.snapshot_tables(ref)
    restored = cluster.restore_tables({k: np.asarray(v) for k, v in arrays.items()},
                                      meta, device="cpu")
    assert restored.plan == plan and restored.spill_count == ref.spill_count
    assert cluster.sampled_miss_rate(restored, ref_rows_t, fused, live, K) == miss


def test_restore_tables_needs_card_unless_cpu(data, monkeypatch):
    """``restore_tables`` puts the tables on the card unless the caller
    asks for the CPU, as ``Index.build`` does; on the CPU it gives back
    the tables it was given."""
    db, _ = data
    state = Index.build(db, metric="l2", k=K, device="cpu").pack().cluster
    assert state is not None
    arrays, meta = cluster.snapshot_tables(state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cluster.restore_tables(arrays, meta)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cluster.restore_tables(arrays, meta, device="cuda")
    back = cluster.restore_tables(arrays, meta, device="cpu")
    assert back.plan == state.plan and back.spill_count == state.spill_count
    for name in ("centroids", "centroid_bias", "cluster_rows", "spill_rows"):
        assert torch.equal(getattr(back, name), getattr(state, name)), name


def _ref_backend(backend):
    return {"torch": "xla", "cuda": "pallas"}[backend]


@pytest.mark.parametrize("storage", ["f32", "int8", "int4"])
@pytest.mark.parametrize("metric", METRICS)
def test_search_on_reference_tables(data, metric, storage):
    """The reference's packed state and tables (``snapshot_state``, its
    ``cluster/*`` arrays restored by ``state_from_arrays``) searched by the
    port's pruned scan, in both layouts, equal the reference's search."""
    db, q = data
    ref = ref_search.Index.build(jnp.asarray(db), metric=metric, k=K,
                                 storage=storage, backend="xla")
    ref.delete(jnp.arange(0, N, 5))
    assert ref.pack().cluster is not None
    arrays, meta = snapshot_state(ref.pack())
    arrays = {name: np.asarray(a) for name, a in arrays.items()}
    rv, ri = ref.search(jnp.asarray(q))
    for backend in ("torch", "cuda"):
        spec = SearchSpec(metric=metric, k=K, storage=storage, backend=backend)
        st = packed.state_from_arrays(arrays, meta, spec, "cpu")
        cp = st.cluster.plan
        v, i = backends.cluster_search_quant(
            torch.from_numpy(q), *st.operands()[:2],
            *((None,) * 3 if storage == "f32" else st.operands()[2:5]),
            *st.cluster.operands(), metric=metric, k=K,
            k_scan=packed.scan_k_for(spec, st.n, live=ref.size),
            probes=cp.probes, target_scan=cp.target_scan,
            int4_packed=st.int4_packed)
        assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(), i.numpy(),
                          score=public_scorer(metric, q, db), **TOL)
        assert not set(range(0, N, 5)) & set(i.numpy().ravel().tolist())


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("metric", METRICS)
def test_index_matches_reference(data, metric, backend):
    """``Index.build`` with the default ``cluster="auto"`` above the
    crossover: the same tables as the reference's index, the same
    searches; ``add`` slots rows as ``assign_rows`` does there; deleted
    rows never come back; ``explain()``'s cluster block has the
    reference's keys and values."""
    db, q = data
    n0 = N - 128
    ours = Index.build(db[:n0], metric=metric, k=K, backend=backend,
                       device="cpu", capacity=N)
    ref = ref_search.Index.build(jnp.asarray(db[:n0]), metric=metric, k=K,
                                 backend=_ref_backend(backend), capacity=N)
    assert ours.spec.cluster == "auto"
    a, b = ours.pack().cluster, ref.pack().cluster
    assert a is not None and b is not None
    assert dataclasses.asdict(a.plan) == dataclasses.asdict(b.plan)

    def same_tables():
        np.testing.assert_array_equal(a.cluster_rows.numpy(),
                                      np.asarray(b.cluster_rows))
        np.testing.assert_array_equal(a.spill_rows.numpy(),
                                      np.asarray(b.spill_rows))
        np.testing.assert_array_equal(a.counts, np.asarray(b.counts))
        assert a.spill_count == b.spill_count

    same_tables()
    np.testing.assert_allclose(a.centroids.numpy(), np.asarray(b.centroids),
                               **TOL)
    assert ours.pack_timings["sampled_miss"] <= cluster.miss_check_threshold(
        a.plan.miss_budget)
    score = public_scorer(metric, q, db)

    def same_search():
        v, i = ours.search(q)
        rv, ri = ref.search(jnp.asarray(q))
        assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(),
                          i.numpy(), score=score, **TOL)
        return i.numpy()

    same_search()
    ours.add(db[n0:])
    ref.add(jnp.asarray(db[n0:]))
    same_tables()
    same_search()
    dead = np.arange(0, N, 3)
    ours.delete(dead)
    ref.delete(jnp.asarray(dead))
    i = same_search()
    assert not set(dead.tolist()) & set(i.ravel().tolist())
    rep, ref_rep = ours.explain(), ref.explain()
    assert sorted(rep["cluster"]) == sorted(ref_rep["cluster"])
    for key, val in ref_rep["cluster"].items():
        assert rep["cluster"][key] == val, key
    assert rep["expected_recall"] == ref_rep["expected_recall"] == ours.expected_recall
    assert rep["expected_recall_live"] == ref_rep["expected_recall_live"]
    assert rep["plan"]["cluster"] == ref_rep["plan"]["cluster"]


def test_lazy_recluster_fires_as_reference():
    """``tests/test_cluster.py``'s spill-growth case on both sides: the
    add past the threshold rebuilds the tables once (the same new tables),
    and the next add does not."""
    db, _ = _mixture(4, n=N - 64)
    ours = Index.build(db, metric="l2", k=K, backend="torch", device="cpu",
                       capacity=N)
    ref = ref_search.Index.build(jnp.asarray(db), metric="l2", k=K,
                                 backend="xla", capacity=N)
    for cs in (ours.pack().cluster, ref.pack().cluster):
        cs.spill_count = min(cs.plan.spill_capacity,
                             cs.spill_baseline + cs.plan.spill_capacity)
        if (cs.spill_count - cs.spill_baseline
                <= cs.plan.spill_capacity * cluster._SPILL_REPLAN_FRACTION):
            cs.spill_baseline = 0
        assert cs.needs_recluster
    packed.PACK_EVENTS.clear()
    REF_EVENTS.clear()
    one = np.ones((1, D), np.float32)
    ours.add(one)
    ref.add(jnp.asarray(one))
    assert packed.PACK_EVENTS["recluster"] == REF_EVENTS["recluster"] == 1
    a, b = ours.pack().cluster, ref.pack().cluster
    assert not a.needs_recluster
    np.testing.assert_array_equal(a.cluster_rows.numpy(), np.asarray(b.cluster_rows))
    np.testing.assert_array_equal(a.spill_rows.numpy(), np.asarray(b.spill_rows))
    ours.add(one)
    assert packed.PACK_EVENTS["recluster"] == 1


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_structureless_data_falls_back(backend):
    """i.i.d. Gaussian rows above the crossover: the planner enables
    pruning, the build's miss check measures the reference's rate and
    drops the tables, and the search is bit-identical to cluster="off"."""
    rng = np.random.default_rng(6)
    db = rng.standard_normal((N, D), dtype=np.float32)
    q = rng.standard_normal((32, D), dtype=np.float32)
    auto = Index.build(db, metric="l2", k=K, backend=backend, device="cpu")
    off = Index.build(db, metric="l2", k=K, backend=backend, device="cpu",
                      cluster="off")
    ref = ref_search.Index.build(jnp.asarray(db), metric="l2", k=K,
                                 backend="xla")
    assert auto.kernel_plan.cluster.enabled and auto.pack().cluster is None
    miss = auto.pack().cluster_rejected_miss
    assert miss == ref.pack().cluster_rejected_miss
    assert miss > cluster.miss_check_threshold(auto.kernel_plan.cluster.miss_budget)
    rep = auto.explain()["cluster"]
    assert rep["rejected_by"] == "sampled_miss_check" and rep["sampled_miss"] == miss
    (av, ai), (ov, oi) = auto.search(q), off.search(q)
    assert torch.equal(av, ov) and torch.equal(ai, oi)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_below_crossover_bit_identical(backend):
    """Below the crossover ``"auto"`` plans no pruning and searches
    bit-identically to ``"off"``; ``explain()`` records the speed-up the
    planner rejected."""
    db, q = _mixture(8, n=2048)
    auto = Index.build(db, metric="mips", k=K, backend=backend, device="cpu")
    off = Index.build(db, metric="mips", k=K, backend=backend, device="cpu",
                      cluster="off")
    assert not auto.kernel_plan.cluster.enabled
    (av, ai), (ov, oi) = auto.search(q), off.search(q)
    assert torch.equal(av, ov) and torch.equal(ai, oi)
    rep = auto.explain()["cluster"]
    assert rep["enabled"] is False
    assert rep["predicted_speedup"] == auto.kernel_plan.cluster.predicted_speedup


# tests/test_recall_guarantee.py::CLUSTER_CORNERS, the "xla" corners on the
# port's "torch" backend and the "pallas" one on "cuda".
CLUSTER_CORNERS = [
    ("mips", "torch", "f32", 10, 0.95, 2, 256),
    ("l2", "torch", "f32", 32, 0.90, 2, 256),
    ("cosine", "torch", "f32", 4, 0.95, 2, 256),
    ("l2", "torch", "int8", 10, 0.95, 2, 256),
    ("l2", "cuda", "f32", 16, 0.90, 1, 128),
]


@pytest.mark.parametrize("metric,backend,storage,k,target,trials,m",
                         CLUSTER_CORNERS)
def test_recall_meets_target_cluster_pruned(metric, backend, storage, k,
                                            target, trials, m):
    """The collision x miss guarantee on mixture corpora: mean recall
    against the exact top-k at least the target less the Hoeffding margin
    (delta 1e-6), with pruning enabled, and the planner's product bound
    at least the target."""
    samples = []
    for t in range(trials):
        db, q = _mixture(17 + t, m=m)
        index = Index.build(db, metric=metric, k=k, recall_target=target,
                            backend=backend, storage=storage, device="cpu")
        assert index.pack().cluster is not None
        assert index.expected_recall >= target
        _, idx = index.search(q)
        _, truth = exact_search(torch.from_numpy(q), torch.from_numpy(db), k,
                                metric=metric)
        for a, b in zip(idx.numpy(), truth.numpy()):
            samples.append(len(set(a.tolist()) & set(b.tolist())) / k)
    eps = math.sqrt(math.log(1e6) / (2 * len(samples)))
    assert float(np.mean(samples)) >= target - eps
