"""The port's planner and roofline against the reference's, on the CPU.

``repro_torch.core.roofline`` and ``repro_torch.search.plan`` against
``repro.core.roofline`` and ``repro.search.plan`` on the same inputs:

  * the roofline functions are equal (to the last bit: the same float
    arithmetic) for every profile the port copies;
  * ``plan_search`` gives the reference's bin plan, ``k_scan`` and
    ``expected_recall`` for every metric, storage tier and batch size
    over the paper's two shapes and small ones, the port's ``"torch"``
    backend the reference's ``"xla"`` prediction too, the ``"cuda"``
    backend the kernels' fixed 128 tiles, and on the ``"h100"`` profile
    the bounds ``chip_smoke.py`` prints (within 1%);
  * ``plan_buckets``, ``PlanCache``, ``tune_plan``/``plan="measure"``,
    ``kernel_plan`` and ``explain()`` behave as the reference's.

Every ``PlanCache`` here has a path under ``tmp_path`` (or none).
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.roofline as ref_roofline
import repro.search as ref_search
import repro.search.plan as ref_plan
from repro_torch.core import roofline
from repro_torch.kernels import partial_reduce as prk
from repro_torch.search import (
    Index,
    PlanCache,
    SearchSpec,
    detect_device,
    plan_buckets,
    plan_search,
    tune_plan,
)
from repro_torch.search import plan as planlib
from repro_torch.testing import assert_topk_close, public_scorer

COPIED = ["v100", "a100", "cpu"]
TIERS = ["f32", "bf16", "int8", "int4"]
METRICS = ["mips", "l2", "cosine"]
# (n, d) of Sift1M and Glove1.2M (src/repro/configs/knn_workloads.py),
# and small ones: a partial tile, bins of one row, D past a lane.
SHAPES = {"sift1m": (1_000_000, 128), "glove1.2m": (1_183_514, 100),
          "small": (1_500, 33), "tiny": (40, 130)}
# port backend -> the reference backend it is held against
PAIRS = {"torch": "xla", "cuda": "pallas"}


def _data(n, d, seed=0, m=9):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d), dtype=np.float32),
            rng.standard_normal((m, d), dtype=np.float32))


# --- roofline ---------------------------------------------------------------


@pytest.mark.parametrize("name", COPIED)
def test_roofline_equals_reference(name):
    hw, ref_hw = roofline.HARDWARE[name], ref_roofline.HARDWARE[name]
    assert dataclasses.astuple(hw) == dataclasses.astuple(ref_hw)
    for m, n, d, l in [(1, 100, 7, 3), (16, 1_003_520, 128, 245),
                       (10_000, 1_000_448, 128, 977)]:
        for c in (3, 6):
            kw = dict(cops_per_dot=c, block_rows=128, dtype_bytes=4,
                      db_bytes=0.5)
            pairs = [
                (roofline.partial_reduce_cost(m, n, d, l, **kw),
                 ref_roofline.partial_reduce_cost(m, n, d, l, **kw)),
                (roofline.partial_reduce_fused_cost(m, n, d, 30, **kw),
                 ref_roofline.partial_reduce_fused_cost(m, n, d, 30, **kw)),
            ]
            for ours, ref in pairs:
                assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
                assert (ours.i_mem, ours.i_cop) == (ref.i_mem, ref.i_cop)
                ref_cost = ref_roofline.KernelCost(*dataclasses.astuple(ours))
                assert roofline.attainable_flops(ours, hw) == \
                    ref_roofline.attainable_flops(ref_cost, ref_hw)
                assert roofline.bottleneck(ours, hw) == \
                    ref_roofline.bottleneck(ref_cost, ref_hw)
    for flags in [{}, dict(l2=True), dict(l2=True, non_pow2_n=True,
                                          broadcast_norm=True, padded_d=True)]:
        assert roofline.cops_per_dot(**flags) == ref_roofline.cops_per_dot(**flags)
    kw = dict(hlo_flops=3e12, hlo_bytes=2e10, collective_bytes=5e8, chips=4,
              ici_links=2)
    ours = roofline.roofline_terms(hw=hw, **kw)
    ref = ref_roofline.roofline_terms(hw=ref_hw, **kw)
    assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
    assert (ours.dominant, ours.step_time_s) == (ref.dominant, ref.step_time_s)


def test_h100_profile():
    """The card's peaks (NVIDIA's H100 SXM data sheet), no TPU profile."""
    hw = roofline.HARDWARE["h100"]
    assert (hw.peak_flops, hw.hbm_bandwidth, hw.hbm_bytes) == (989.4e12, 3.35e12,
                                                               80e9)
    assert hw.peak_cops == pytest.approx(33.45e12, rel=1e-3)
    assert hw.vmem_bytes == 227 * 1024
    assert sorted(roofline.HARDWARE) == ["a100", "cpu", "h100", "v100"]


# --- plan_search ------------------------------------------------------------


@pytest.mark.parametrize("device", ["a100", "cpu"])
@pytest.mark.parametrize("backend", sorted(PAIRS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_search_equals_reference(shape, backend, device):
    n, d = SHAPES[shape]
    for metric in METRICS:
        for storage in TIERS:
            for m in (16, 10_000):
                kw = dict(n=n, d=d, k=10, m=m, metric=metric,
                          recall_target=0.95, storage=storage, device=device)
                ours = plan_search(backend=backend, **kw)
                ref = ref_plan.plan_search(backend=PAIRS[backend], **kw)
                where = (metric, storage, m)
                assert dataclasses.astuple(ours.bin_plan) == \
                    dataclasses.astuple(ref.bin_plan), where
                assert (ours.k_scan, ours.expected_recall, ours.d_pad,
                        ours.rescore) == (ref.k_scan, ref.expected_recall,
                                          ref.d_pad, ref.rescore), where
                assert (ours.block_m, ours.block_n) == (prk.BLOCK_M, prk.BLOCK_N)
                if backend == "torch":
                    # the same program as the reference's xla path, priced
                    # the same way
                    for field in ("query_block", "flops", "hbm_bytes", "cops",
                                  "attainable_flops", "bottleneck",
                                  "predicted_s", "predicted_qps"):
                        assert getattr(ours, field) == getattr(ref, field), \
                            (where, field)


# The bounds chip_smoke.py prints at the Sift1M shape: the tensor-core
# passes at M=10,000 (989 TFLOP/s) and the bytes at M=16 (3.35 TB/s).
H100_BOUNDS_MS = {("f32", 10_000): 15.586, ("bf16", 10_000): 7.777,
                  ("int8", 10_000): 7.777, ("int4", 10_000): 7.769,
                  ("f32", 16): 0.155}


@pytest.mark.parametrize("storage,m", sorted(H100_BOUNDS_MS))
def test_h100_prediction_is_the_bound(storage, m):
    p = plan_search(n=1_000_000, d=128, k=10, m=m, metric="l2",
                    backend="cuda", device="h100", storage=storage)
    assert p.predicted_s * 1e3 == pytest.approx(H100_BOUNDS_MS[storage, m],
                                                rel=0.01)
    assert p.bottleneck == ("compute" if m == 10_000 else "memory")
    # the kernels' own split plan for the batch, reported beside the plan
    block_n = max(p.bin_size, prk.BLOCK_N)  # the CUDA layout's row unit
    n_pad = -(-1_000_000 // block_n) * block_n
    assert p.splits == prk.split_plan(m, n_pad, p.bin_size, 132, p.k_scan)[1]
    assert p.summary()["splits"] == p.splits


def test_plan_search_pins_and_errors():
    p = plan_search(n=5000, d=16, k=5, block_m=128, max_block_n=128,
                    query_block=64, device="cpu")
    assert (p.source, p.query_block) == ("user", 64)
    assert plan_search(n=5000, d=16, k=5, device="cpu").source == "model"
    with pytest.raises(NotImplementedError, match="fixed at 128x128"):
        plan_search(n=5000, d=16, k=5, block_m=256, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        plan_search(n=5000, d=16, k=5, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="unknown device profile"):
        plan_search(n=5000, d=16, k=5, device="tpu_v4")
    with pytest.raises(ValueError, match="quantized"):
        plan_search(n=5000, d=16, k=5, rescore=True, device="cpu")


@pytest.mark.parametrize("n", [1, 4, 7, 8, 9, 64, 100, 4096, 5000])
def test_plan_buckets_equals_reference(n):
    assert plan_buckets(n) == ref_plan.plan_buckets(n)
    assert plan_buckets(n, min_bucket=3) == ref_plan.plan_buckets(n, min_bucket=3)


def test_detect_device(monkeypatch):
    assert detect_device(device="cpu") == "cpu"
    assert detect_device("h100") == "h100"
    with pytest.raises(ValueError, match="unknown device profile"):
        detect_device("tpu_v5e")
    for card, profile in (("NVIDIA H100 80GB HBM3", "h100"),
                          ("NVIDIA A100-SXM4-40GB", "a100"),
                          ("NVIDIA L4", "a100")):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: card)
        assert detect_device(device="cuda") == profile


# --- Index: kernel_plan, Plan objects, explain ------------------------------


@pytest.mark.parametrize("backend", sorted(PAIRS))
def test_index_kernel_plan_equals_reference(backend):
    db, _ = _data(1500, 33)
    kw = dict(metric="l2", k=6, storage="int8")
    ours = Index.build(db, backend=backend, device="cpu", profile="a100", **kw)
    ref = ref_search.Index.build(jnp.asarray(db), backend=PAIRS[backend],
                                 cluster="off", device="a100", **kw)
    kp, rp = ours.kernel_plan, ref.kernel_plan
    assert dataclasses.astuple(kp.bin_plan) == dataclasses.astuple(rp.bin_plan)
    assert (kp.k_scan, kp.source, kp.device) == (rp.k_scan, rp.source, "a100")
    assert ours.spec.block_m == kp.block_m == prk.BLOCK_M
    assert ours.spec.query_block == kp.query_block
    # growth re-plans the row space with the same tiles
    ours.add(np.zeros((1000, 33), np.float32))
    ref.add(jnp.zeros((1000, 33)))
    assert ours.kernel_plan.n == ours.capacity == ref.kernel_plan.n
    assert dataclasses.astuple(ours.kernel_plan.bin_plan) == \
        dataclasses.astuple(ref.kernel_plan.bin_plan)


def test_build_takes_a_plan_object():
    db, q = _data(700, 24)
    p = plan_search(n=700, d=24, k=5, backend="cuda", device="h100",
                    query_block=64)
    idx = Index.build(db, k=5, backend="cuda", device="cpu", plan=p)
    assert idx.kernel_plan is p and idx.spec.query_block == 64
    base = Index.build(db, k=5, backend="cuda", device="cpu")
    (v, i), (bv, bi) = idx.search(q), base.search(q)
    assert_topk_close(bv.numpy(), bi.numpy(), v.numpy(), i.numpy(),
                      score=public_scorer("mips", q, db))
    with pytest.raises(ValueError, match="plan must be"):
        Index.build(db, k=5, device="cpu", plan="fast")


def _keys(report):
    return {key: sorted(val) if isinstance(val, dict) else None
            for key, val in report.items()}


def test_explain_keys_equal_reference():
    db, _ = _data(600, 20)
    ours = Index.build(db, k=4, backend="torch", device="cpu", profile="cpu",
                       cluster="off")
    ref = ref_search.Index.build(jnp.asarray(db), k=4, backend="xla",
                                 cluster="off", device="cpu")
    rep = ours.explain(m=32, measure=True, validate_hlo=True)
    ref_rep = ref.explain(m=32, measure=True, validate_hlo=True)
    ours_keys, ref_keys = _keys(rep), _keys(ref_rep)
    # the port's plan carries the reference's shard fields (PR 24) and
    # the kernels' splits; its FLOP cross-check the reference's keys and
    # split_passes
    assert ours_keys.pop("plan") == sorted(set(ref_keys.pop("plan"))
                                           | {"splits"})
    assert ours_keys.pop("hlo") == sorted(set(ref_keys.pop("hlo"))
                                          | {"split_passes"})
    assert ours_keys == ref_keys
    assert rep["hlo"]["flops_ratio"] == pytest.approx(
        ref_rep["hlo"]["flops_ratio"])
    # the same dense program, priced the same on the same profile
    assert rep["predicted"] == ref_rep["predicted"]
    assert rep["storage"] == {k: (tuple(v) if isinstance(v, list) else v)
                              for k, v in ref_rep["storage"].items()}
    assert rep["plan"]["m"] == 32 and rep["measured"]["wall_s"] > 0
    assert rep["measured"]["roofline_fraction"] == pytest.approx(
        rep["predicted"]["wall_s"] / rep["measured"]["wall_s"])
    json.dumps(rep)


# --- plan="measure", PlanCache ----------------------------------------------


def test_plan_cache_round_trip(tmp_path, monkeypatch):
    p = plan_search(n=1000, d=16, k=5, backend="cuda", device="h100")
    path = tmp_path / "plans.json"
    cache = PlanCache(str(path))
    assert len(cache) == 0 and cache.get(p) is None
    entry = {"block_m": 128, "block_n": 128, "query_block": 64,
             "wall_s": 1e-3, "source": "measure"}
    cache.put(p, entry, card="NVIDIA H100 80GB HBM3")
    assert cache.get(p) is None  # another card's measurement
    again = PlanCache(str(path))
    assert again.get(p, card="NVIDIA H100 80GB HBM3") == entry
    pinned = SearchSpec(k=5, query_block=64)
    assert again.get(p, pinned, card="NVIDIA H100 80GB HBM3") is None
    # the port's own variable, never the reference's
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "reference.json"))
    assert PlanCache().path is None
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(path))
    assert len(PlanCache()) == 1
    path.write_text("{not json")
    assert len(PlanCache(str(path))) == 0


def test_tune_plan_varies_only_query_block(tmp_path, monkeypatch):
    timed = []

    def fake_time(index, queries, **kw):
        timed.append(index.spec.query_block)
        return {8: 3.0, 16: 1.0, 32: 2.0}[index.spec.query_block]

    monkeypatch.setattr(planlib, "time_search", fake_time)
    db, _ = _data(300, 16)
    p = plan_search(n=300, d=16, k=5, backend="cuda", device="cpu",
                    query_block=16)
    p = dataclasses.replace(p, source="model")
    cands = planlib._tile_candidates(p)
    assert cands == [(128, 128, 16), (128, 128, 8), (128, 128, 32)]
    assert planlib._tile_candidates(p, SearchSpec(query_block=16)) == \
        [(128, 128, 16)]
    cache = PlanCache(str(tmp_path / "plans.json"))
    tuned = tune_plan(torch.from_numpy(db), p, cache=cache, repeats=1)
    assert timed == [16, 8, 32]
    assert (tuned.source, tuned.query_block, tuned.block_m) == ("measure", 16, 128)
    assert dataclasses.astuple(tuned.bin_plan) == dataclasses.astuple(p.bin_plan)
    assert tune_plan(torch.from_numpy(db), p, cache=cache).query_block == 16
    assert timed == [16, 8, 32]  # the cache hit ran no timing


@pytest.mark.parametrize("backend", sorted(PAIRS))
def test_measured_plan_searches_as_the_model_plan(backend, tmp_path, monkeypatch):
    calls = []
    real = planlib.time_search
    monkeypatch.setattr(planlib, "time_search",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    db, q = _data(500, 12, m=40)
    kw = dict(metric="cosine", k=5, storage="int4", backend=backend,
              device="cpu")
    cache = PlanCache(str(tmp_path / "plans.json"))
    measured = Index.build(db, plan="measure", plan_cache=cache, **kw)
    assert measured.kernel_plan.source == "measure" and len(calls) == 3
    again = Index.build(db, plan="measure", plan_cache=cache, **kw)
    assert len(calls) == 3 and again.kernel_plan == measured.kernel_plan
    model = Index.build(db, **kw)
    assert dataclasses.astuple(measured.plan) == dataclasses.astuple(model.plan)
    (v, i), (mv, mi) = measured.search(q), model.search(q)
    assert_topk_close(mv.numpy(), mi.numpy(), v.numpy(), i.numpy(),
                      score=public_scorer("cosine", q, db))
    # every tile pinned: the plan is the user's, nothing is timed
    pinned = Index.build(db, plan="measure", plan_cache=cache, block_m=128,
                         max_block_n=128, query_block=8, **kw)
    assert pinned.kernel_plan.source == "user" and len(calls) == 3


# --- C3: the "h100" profile's veto of a cluster plan that loses on the card ---


@pytest.mark.parametrize("storage", TIERS)
def test_h100_vetoes_pruning_at_the_sift1m_shape(storage):
    """The crossover enables pruning at the Sift1M shape, and on every
    profile the reference has the plan is the reference's field for field;
    the card's profile drops it (both predicted times kept, the pruned
    scan priced above the dense one) and predicts the dense scan."""
    n, d = SHAPES["sift1m"]
    kw = dict(n=n, d=d, k=10, metric="l2", recall_target=0.95,
              storage=storage, cluster="auto")
    for device in COPIED:
        ours = plan_search(backend="torch", device=device, **kw)
        ref = ref_plan.plan_search(backend="xla", device=device, **kw)
        assert ours.cluster.enabled and ours.cluster_veto is None
        assert dataclasses.asdict(ours.cluster) == dataclasses.asdict(ref.cluster)
        for field in ("flops", "hbm_bytes", "cops", "predicted_s",
                      "expected_recall", "k_scan", "num_bins"):
            assert getattr(ours, field) == getattr(ref, field), (device, field)
    card = plan_search(backend="cuda", device="h100", **kw)
    dense = plan_search(backend="cuda", device="h100", **dict(kw, cluster="off"))
    assert not card.cluster.enabled
    pruned_s, dense_s = card.cluster_veto
    assert pruned_s >= dense_s == dense.predicted_s == card.predicted_s
    assert card.expected_recall == dense.expected_recall
    assert "cluster_veto" not in card.summary()  # the reference's plan keys
    # the veto prices the pruned scan as the port runs it: with the
    # materialized gather it loses at every batch the build plans for
    for m in (16, 10_000):
        assert plan_search(backend="cuda", device="h100", m=m,
                           **kw).cluster_veto is not None


def test_veto_is_pinned_at_build():
    """A vetoed build runs no k-means and keeps the veto in every re-plan
    (``explain(m=...)``, growth), even at a batch where the model alone
    would prune; ``explain()`` reports both predicted times.  The
    ``"a100"`` profile keeps the reference's decision on the same data."""
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((16, 16)).astype(np.float32) * 2.5
    db = centers[rng.integers(0, 16, 12_000)] + rng.standard_normal(
        (12_000, 16), dtype=np.float32)
    from repro_torch.search import PACK_EVENTS

    PACK_EVENTS.clear()
    ix = Index.build(db, metric="l2", k=10, backend="cuda", device="cpu",
                     profile="h100", capacity_block=4096)
    assert ix.kernel_plan.cluster_veto is not None
    assert ix.pack().cluster is None and ix.pack().cluster_rejected_miss is None
    assert ix.pack_timings == {}
    assert "cluster_built" not in PACK_EVENTS and "cluster_rejected" not in PACK_EVENTS
    block = ix.explain()["cluster"]
    assert not block["enabled"] and block["vetoed_by"] == "h100_cost_model"
    assert block["predicted_pruned_s"] >= block["predicted_dense_s"] > 0
    # at one query the model alone would prune; the pin keeps the build's
    assert plan_search(n=ix.capacity, d=16, k=10, m=1, metric="l2",
                       backend="cuda", device="h100", cluster="auto").cluster.enabled
    one = ix.explain(m=1)["cluster"]
    assert not one["enabled"] and "vetoed_by" in one
    ix.add(db[:5000])  # growth re-plans with the pin
    assert ix.capacity > 12_000 and ix.kernel_plan.cluster_veto is not None
    assert ix.pack().cluster is None
    a100 = Index.build(db, metric="l2", k=10, backend="cuda", device="cpu",
                       profile="a100")
    assert a100.kernel_plan.cluster_veto is None
    assert a100.pack().cluster is not None
    assert a100.explain(m=1)["cluster"]["enabled"]


def test_veto_is_priced_when_an_index_grows_past_the_crossover():
    """An index built below the crossover has no cluster decision to pin;
    the re-plan of the growth that carries it past the crossover prices
    the plan on the ``"h100"`` model, which vetoes it, and that decision
    is pinned from then on: no k-means, the dense scan's prediction, and
    ``explain(m=1)`` keeps the veto where the model alone would prune."""
    rng = np.random.default_rng(4)
    db = rng.standard_normal((12_000, 16), dtype=np.float32)
    from repro_torch.search import PACK_EVENTS

    ix = Index.build(db[:4000], metric="l2", k=10, backend="cuda",
                     device="cpu", profile="h100", capacity_block=4096)
    assert not ix.kernel_plan.cluster.enabled
    assert ix.kernel_plan.cluster_veto is None
    ix.pack()
    PACK_EVENTS.clear()
    ix.add(db[4000:])  # growth to 12,288 rows, past the crossover
    assert ix.capacity > 8192
    assert ix.kernel_plan.cluster_veto is not None
    assert not ix.kernel_plan.cluster.enabled
    dense = plan_search(n=ix.capacity, d=16, k=10, metric="l2",
                        backend="cuda", device="h100", cluster="off",
                        query_block=ix.kernel_plan.query_block)
    assert ix.kernel_plan.predicted_s == dense.predicted_s
    assert ix.pack().cluster is None
    assert "cluster_built" not in PACK_EVENTS and "cluster_rejected" not in PACK_EVENTS
    one = ix.explain(m=1)["cluster"]
    assert not one["enabled"] and one["vetoed_by"] == "h100_cost_model"
