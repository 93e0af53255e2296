"""The host-RAM cold tier of the port against the reference's.

``Index.build(..., residency="host")`` in ``repro_torch`` against the same
build in ``repro.search`` (its ``"xla"`` host tier, built in each test):
the segment plan and the ``Plan`` host fields are equal exactly; searches
over the waves agree (values ``allclose``, indices equal except where the
reference's own values tie, ``repro_torch.testing``) for every metric and
tier, under deletes, add/delete interleavings, growth and snapshots both
ways.  The reference's grid (``tests/test_sharded2d.py``): N=4999, a
2^18-byte budget, five 1024-row waves.  Where a segment holds whole bins,
the port's host f32 search is its HBM index's bit for bit.  On the CPU
the port's waves copy into their slots plainly; the card's side stream and
pinned copies are ``tests/test_torch_cuda.py``'s.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.search import Index as RefIndex
from repro.search import plan as ref_plan
from repro_torch.core.binning import plan_bins
from repro_torch.kernels import partial_reduce as prk
from repro_torch.search import (
    DISPATCH_COUNTS,
    PACK_EVENTS,
    SEGMENT_ALIGN,
    Index,
    SearchServer,
    SearchSpec,
    ServeConfig,
    VirtualClock,
    plan_search,
    plan_segments,
    telemetry,
)
from repro_torch.search import plan as planlib
from repro_torch.search.hosttier import wave_bins
from repro_torch.testing import assert_topk_close

N, D, M, K = 4999, 32, 24, 7
BUDGET = 2 ** 18  # the minimum 1024-row segment: five waves at N=4999
METRICS = ["mips", "l2", "cosine"]
STORAGES = ["f32", "int8", "int4"]
# port backend -> the reference backend it is held against ("cuda" runs
# its kernels' plain versions on the CPU; the reference's host tier is
# "xla" only)
PAIRS = {"torch": "xla", "cuda": "xla"}


def _data(seed=7, n=N, m=M, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d), dtype=np.float32),
            rng.standard_normal((m, d), dtype=np.float32))


def _pair(db, backend="torch", **kw):
    kw = dict(dict(k=K, cluster="off", residency="host"), **kw)
    ours = Index.build(db, device="cpu", backend=backend, **kw)
    ref = RefIndex.build(jnp.asarray(db), backend=PAIRS[backend], **kw)
    return ours, ref


def _close(ref, ours, **tol):
    rv, ri = (np.asarray(x) for x in ref)
    ov, oi = (np.asarray(x) for x in ours)
    assert_topk_close(rv, ri, ov, oi, **tol)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(autouse=True)
def _counters():
    DISPATCH_COUNTS.clear(), PACK_EVENTS.clear(), prk.reset_counts()
    yield


# --- the plan ----------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 1000, 4999, 1 << 20])
@pytest.mark.parametrize("db_bytes", [4, 2, 1, 0.5])
@pytest.mark.parametrize("rescore", [False, True])
def test_plan_segments_equal_reference(n, db_bytes, rescore):
    for budget in (1.0, 2 ** 18, 2 ** 22, 3.3e9, 80e9):
        for seg in (None, 1024, 5000):
            kw = dict(n=n, d=100, db_bytes=db_bytes, hbm_budget_bytes=budget,
                      rescore=rescore, segment_rows=seg)
            assert plan_segments(**kw) == ref_plan.plan_segments(**kw), kw
    assert SEGMENT_ALIGN == ref_plan.SEGMENT_ALIGN
    with pytest.raises(ValueError):
        plan_segments(n=10, d=4, db_bytes=4, hbm_budget_bytes=0)


HOST_FIELDS = ("residency", "segment_rows", "num_segments", "hbm_budget_bytes")


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("profile", ["cpu", "a100", "v100"])
def test_plan_host_fields_equal_reference(storage, profile):
    for n, budget, seg in ((4999, BUDGET, None), (4999, None, None),
                           (100_000, 5e6, None), (100_000, None, 2048)):
        kw = dict(n=n, d=D, k=K, m=16, metric="l2", storage=storage,
                  device=profile, cluster="auto", residency="host",
                  hbm_budget_bytes=budget, segment_rows=seg)
        ours = plan_search(backend="torch", **kw)
        ref = ref_plan.plan_search(backend="xla", **kw)
        for field in HOST_FIELDS + ("query_block", "num_bins",
                                    "log2_bin_size", "k_scan", "predicted_s"):
            assert getattr(ours, field) == getattr(ref, field), (field, kw)
        assert ours.cluster is None and ref.cluster is None  # never pruned
        hbm = plan_search(backend="torch", **dict(kw, residency="hbm"))
        assert (hbm.residency, hbm.segment_rows, hbm.num_segments,
                hbm.hbm_budget_bytes) == ("hbm", 0, 0, 0.0)


def test_measure_times_a_host_plan_on_the_compute_device(monkeypatch):
    """plan="measure" for a host index: its rows live in host memory, but
    the candidates are built and timed on the device the index searches
    on, over the plan's own segments, and the result is cached under that
    device's name apart from an HBM plan of the same shape."""
    plan = plan_search(n=3072, d=D, k=K, device="cpu", residency="host",
                       hbm_budget_bytes=BUDGET)
    assert (plan.segment_rows, plan.num_segments) == (1024, 3)
    built = []

    def fake_build(database, **kw):
        built.append((kw["device"], kw["spec"].residency,
                      kw["spec"].segment_rows))
        return object()

    monkeypatch.setattr(Index, "build", fake_build)
    monkeypatch.setattr(planlib, "time_search", lambda *a, **kw: 1.0)
    cache = planlib.PlanCache()
    rows = torch.empty((3072, D), device="meta")  # not where searches run
    tuned = planlib.tune_plan(rows, plan, cache=cache, device="cpu")
    assert tuned.source == "measure" and len(cache) == 1
    assert built and all(b == (torch.device("cpu"), "host", 1024)
                         for b in built)
    (key,) = cache._entries
    assert key.startswith("cpu/") and key.endswith("/host1024")
    hbm = plan_search(n=3072, d=D, k=K, device="cpu")
    assert cache.get(hbm, card="cpu") is None


def test_build_measures_a_host_plan_where_it_searches(monkeypatch):
    seen = []
    real = planlib.tune_plan

    def spy(database, plan, **kw):
        seen.append((database.device, kw["device"]))
        return real(database, plan, **kw)

    monkeypatch.setattr(planlib, "tune_plan", spy)
    db, _ = _data(21, n=3000)
    index = Index.build(db, k=K, cluster="off", device="cpu",
                        residency="host", hbm_budget_bytes=BUDGET,
                        plan="measure", plan_cache=planlib.PlanCache())
    assert seen == [(torch.device("cpu"), index.device)]
    assert index.kernel_plan.source == "measure"
    assert index.kernel_plan.segment_rows == 1024


@pytest.mark.parametrize("seg", [1000, 1024, 3072, 5120, 122_880, 125_952])
@pytest.mark.parametrize("capacity_waves", [1, 5, 9])
@pytest.mark.parametrize("k,target", [(2, 0.8), (10, 0.95)])
def test_cuda_wave_bins_tile_the_slot(seg, capacity_waves, k, target):
    """On "cuda" a wave's bins tile its BLOCK_N-rounded slot: the planned
    bin where it does, else the largest power of two dividing the slot
    (more bins, E[recall] no lower); "torch" keeps the planned bins."""
    cap = seg * capacity_waves
    planned = plan_bins(seg, k, target, reduction_input_size_override=cap)
    assert wave_bins(seg, k, target, cap, "torch") == planned
    got = wave_bins(seg, k, target, cap, "cuda")
    slot = -(-seg // prk.BLOCK_N) * prk.BLOCK_N
    assert slot % got.bin_size == 0 and got.bin_size <= planned.bin_size
    assert got.padded_n <= slot and got.num_bins * got.bin_size >= seg
    assert got.expected_recall >= planned.expected_recall
    if slot % planned.bin_size == 0:
        assert got == planned


def test_cuda_slots_stay_in_an_unaligned_budget():
    """A budget-planned 3072-row segment over which the planned bins hold
    2048 rows: on "cuda" the wave scans 1024-row bins, so the two slots
    are the segment's rows (sized at the kernels' 128 lanes a row) and fit
    the budget, and the search is the top-k of every 1024-row bin's winner
    (the rule of the bins it scans)."""
    n, d, k, target = 15_000, 16, 2, 0.8
    db, q = _data(23, n=n, m=40, d=d)
    budget = 2 * 3072 * (128 * 4 + 8)
    # the reference's plan (and "torch"'s) sizes the rows at d lanes
    assert plan_segments(n=n, d=d, db_bytes=4, hbm_budget_bytes=budget)[0] \
        == 3072 * (128 * 4 + 8) // (d * 4 + 8) // 1024 * 1024
    index = Index.build(db, k=k, recall_target=target, cluster="off",
                        device="cpu", backend="cuda", residency="host",
                        hbm_budget_bytes=budget)
    searcher = index.host_searcher()
    assert (index.kernel_plan.segment_rows, index.capacity) == (3072, 15_360)
    assert plan_bins(3072, k, target, reduction_input_size_override=15_360
                     ).bin_size == 2048
    assert searcher.bin_size == 1024 and searcher.slot_rows == 3072
    slot_bytes = sum(t.numel() * t.element_size() for s in searcher.slots
                     for t in s.values() if t is not None)
    assert slot_bytes <= budget
    got = index.search(q)
    scores = q @ np.pad(db, ((0, 15_360 - n), (0, 0))).T
    scores[:, n:] = -np.inf
    bins = scores.reshape(len(q), -1, 1024)
    win = bins.argmax(-1) + np.arange(bins.shape[1]) * 1024
    win_v = np.take_along_axis(scores, win, 1)
    top = np.argsort(-win_v, axis=1, kind="stable")[:, :k]
    assert_topk_close(np.take_along_axis(win_v, top, 1),
                      np.take_along_axis(win, top, 1),
                      got.values.numpy(), got.indices.numpy())


def test_spec_checks_equal_reference():
    from repro.search import SearchSpec as RefSpec

    for kw in (dict(residency="disk"), dict(segment_rows=0),
               dict(residency="host", aggregate_to_topk=False)):
        with pytest.raises(ValueError):
            RefSpec(**kw)
        with pytest.raises(ValueError):
            SearchSpec(**kw)
    assert SearchSpec(residency="host", segment_rows=2048).segment_rows == 2048
    # the divergence: the port's "cuda" backend scans host waves
    assert SearchSpec(residency="host", backend="cuda").backend == "cuda"
    with pytest.raises(ValueError):
        RefSpec(residency="host", backend="pallas")


# --- searches against the reference's host tier --------------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", METRICS)
def test_host_search_matches_reference(metric, storage, backend):
    db, q = _data()
    ours, ref = _pair(db, backend, metric=metric, storage=storage,
                      hbm_budget_bytes=BUDGET)
    waves = ours.explain()["residency"]["num_segments"]
    assert waves == ref.explain()["residency"]["num_segments"] == 5
    assert ours.capacity == ref.capacity == 5 * 1024
    _, first = ref.search(jnp.asarray(q))
    dead = np.unique(np.asarray(first)[:, 0])
    ours.delete(dead), ref.delete(jnp.asarray(dead))
    DISPATCH_COUNTS.clear()
    got = ours.search(q)
    assert DISPATCH_COUNTS["host"] == waves and len(DISPATCH_COUNTS) == 1
    _close(ref.search(jnp.asarray(q)), got)
    ids = got.indices.numpy()
    assert ids.max() < N and not set(ids.ravel().tolist()) & set(dead.tolist())


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("metric", METRICS)
def test_host_f32_bit_equal_to_hbm(metric, backend):
    """Segments of whole bins: the waves' top-k merge to the HBM index's,
    bit for bit, ties to the lowest index included."""
    db, q = _data(11)
    host = Index.build(db, metric=metric, k=K, cluster="off", device="cpu",
                       backend=backend, residency="host", segment_rows=1024)
    hbm = Index.build(db, metric=metric, k=K, cluster="off", device="cpu",
                      backend=backend)
    wave_bin = plan_bins(1024, K, 0.95,
                         reduction_input_size_override=host.capacity).bin_size
    assert 1024 % wave_bin == 0 and wave_bin == hbm.pack().bin_size
    dead = np.arange(0, N, 7)
    host.delete(dead), hbm.delete(dead)
    # two copies of row 3000 appended (rows 4999 and 5000, one bin): the
    # queries near it see equal values in two waves
    for idx in (host, hbm):
        idx.add(np.stack([db[3000], db[3000]]))
    assert _equal(host.search(q), hbm.search(q))
    assert _equal(host.search(db[2990:3010]), hbm.search(db[2990:3010]))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_one_dispatch_a_wave_and_no_rebuild(backend):
    db, q = _data(12, n=3000)
    index = Index.build(db, k=K, cluster="off", device="cpu", backend=backend,
                        residency="host", segment_rows=1024)
    waves = index.capacity // 1024
    assert waves == 3
    index.search(q)
    searcher = index.host_searcher()
    slots = [t.data_ptr() for s in searcher.slots for t in s.values()
             if t is not None]
    DISPATCH_COUNTS.clear(), prk.reset_counts(), PACK_EVENTS.clear()
    reg = telemetry.registry()
    waves0 = reg.counter_value("repro_hosttier_waves_total", segment_rows=1024)
    for m in (M, 1, 100):  # any batch, one wave stream
        index.search(q[:m] if m <= M else np.tile(q, (5, 1))[:m])
    assert index.host_searcher() is searcher
    assert slots == [t.data_ptr() for s in searcher.slots for t in s.values()
                     if t is not None]
    assert dict(DISPATCH_COUNTS) == {"host": 3 * waves}
    assert not PACK_EVENTS and not prk.LAUNCHES
    if backend == "cuda":  # the fused scan's plain version, one a wave
        assert dict(prk.PLAIN_CALLS) == {"partial_reduce_fused": 3 * waves}
    assert reg.gauge_value("repro_hosttier_segments", segment_rows=1024) \
        == waves
    assert reg.counter_value("repro_hosttier_waves_total",
                             segment_rows=1024) - waves0 == 3 * waves


def test_occupancy_equals_reference():
    db = np.random.default_rng(3).standard_normal((2048, 16), dtype=np.float32)
    ours, ref = _pair(db, metric="mips", k=3, segment_rows=1024)
    ref_searcher = ref._build_host_searcher()
    assert ours.host_searcher().occupancy(ours.pack()) \
        == ref_searcher.occupancy(ref.pack()) == [1.0, 1.0]
    ours.delete(np.arange(1024)), ref.delete(jnp.arange(1024))
    assert ours.host_searcher().occupancy(ours.pack()) \
        == ref_searcher.occupancy(ref.pack()) == [0.0, 1.0]


@pytest.mark.parametrize("storage", STORAGES)
def test_explain_residency_equals_reference(storage):
    db, _ = _data(13)
    ours, ref = _pair(db, metric="l2", storage=storage,
                      hbm_budget_bytes=BUDGET)
    a, b = ours.explain(), ref.explain()
    assert a["residency"] == b["residency"]
    assert a["residency"]["schedule"][-1] == {"wave": 4, "rows": [4096, 5120]}
    assert a["storage"]["db_resident_bytes"] == b["storage"]["db_resident_bytes"]
    for field in HOST_FIELDS:
        assert a["plan"][field] == b["plan"][field]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("storage", STORAGES)
def test_add_delete_growth_match_reference(storage, backend):
    """Interleaved adds (one grows capacity by whole segments) and deletes,
    each followed by a search, against the reference's host tier."""
    db, q = _data(14, n=2500)
    ours, ref = _pair(db[:2000], backend, metric="l2", storage=storage,
                      segment_rows=1024)
    assert ours.capacity == ref.capacity == 2048
    steps = [("add", db[2000:2040]), ("delete", np.arange(0, 2040, 5)),
             ("add", db[2040:2500]), ("delete", np.arange(2100, 2300)),
             ("add", db[:10] + 0.5)]
    for op, arg in steps:
        if op == "add":
            ours.add(arg), ref.add(jnp.asarray(arg))
        else:
            ours.delete(arg), ref.delete(jnp.asarray(arg))
        assert ours.capacity == ref.capacity and ours.capacity % 1024 == 0
        assert ours.size == ref.size
        DISPATCH_COUNTS.clear()
        _close(ref.search(jnp.asarray(q)), ours.search(q))
        assert DISPATCH_COUNTS["host"] == ours.capacity // 1024
    assert ours.capacity == 3072  # grown by a whole segment
    assert ours.explain()["residency"] == ref.explain()["residency"]


def test_growth_rebuilds_the_searcher_once():
    db, q = _data(15, n=1500)
    index = Index.build(db[:1000], k=K, cluster="off", device="cpu",
                        residency="host", segment_rows=1024)
    index.search(q)
    first = index.host_searcher()
    index.add(db[1000:1020])                # in place: same layout
    assert index.host_searcher() is first
    index.add(db[1020:1500])                # grows to 2048 rows
    assert index.capacity == 2048 and index.host_searcher() is not first


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_snapshot_round_trips(tmp_path, storage):
    """Port -> port bit for bit without re-packing, reference -> port and
    port -> reference within the tie-aware rule; residency and the segment
    schedule ride in the spec."""
    db, q = _data(16, n=2048)
    ours = Index.build(db, metric="l2", k=8, storage=storage, device="cpu",
                       backend="torch", residency="host", segment_rows=1024,
                       cluster="off")
    ours.delete([3, 700, 1500])
    direct = ours.search(q)
    PACK_EVENTS.clear()
    back = Index.restore(ours.save(os.path.join(tmp_path, "ours")),
                         device="cpu")
    assert dict(PACK_EVENTS) == {"restore": 1}
    assert back.spec == ours.spec and back.spec.segment_rows == 1024
    assert back.explain()["residency"]["num_segments"] == 2
    assert _equal(back.search(q), direct)
    ref = RefIndex.restore(ours.save(os.path.join(tmp_path, "ours2")))
    assert ref.spec.residency == "host" and ref.spec.segment_rows == 1024
    _close(ref.search(jnp.asarray(q)), direct)
    ref_built = RefIndex.build(jnp.asarray(db), metric="l2", k=8,
                               storage=storage, residency="host",
                               segment_rows=1024, cluster="off")
    ref_built.delete(jnp.asarray([3, 700, 1500]))
    mine = Index.restore(ref_built.save(os.path.join(tmp_path, "ref")),
                         device="cpu")
    assert mine.spec.residency == "host"
    assert mine.explain()["residency"] == ref_built.explain()["residency"]
    _close(ref_built.search(jnp.asarray(q)), mine.search(q))


def test_served_host_index_matches_direct():
    """A server over a host index searches each batch eagerly (no graph on
    the card; on the CPU every batch is eager anyway)."""
    db, _ = _data(17, n=2048)
    index = Index.build(db, k=5, cluster="off", device="cpu",
                        residency="host", segment_rows=1024)
    server = SearchServer(index, ServeConfig(max_batch=16),
                          clock=VirtualClock())
    reqs = [_data(18 + i, n=1, m=1 + 3 * i)[1] for i in range(4)]
    tickets = [server.submit(r) for r in reqs]
    server.run_until_idle()
    for r, t in zip(reqs, tickets):
        direct = index.search(r)
        assert_topk_close(direct.values.numpy(), direct.indices.numpy(),
                          t.result().values.numpy(), t.result().indices.numpy())
    assert server.stats()["graph_replays"] == 0
