"""``repro_torch.search.serve`` against ``repro.search.serve``, on the CPU.

The port of ``tests/test_serve.py``'s virtual-clock suite (the datastore
and engine integrations wait for ROADMAP queue A item 12), and parity
with the reference: the same request stream on a ``VirtualClock`` gives
the reference's batches, coalesced requests, padded rows, latencies and
per-ticket results.  On the CPU there are no CUDA graphs: each batch is
an eager search of the staged block, and PyTorch's matmul takes another
path for one query row than for a block (MKL's gemv), so a served row is
held to a direct search of its request with the shared tie-aware helper;
the card tests (``tests/test_torch_cuda.py``) hold graph replays to
direct searches bit for bit.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.search import Index as RefIndex
from repro.search import SearchServer as RefServer
from repro.search import ServeConfig as RefConfig
from repro.search import VirtualClock as RefClock
from repro_torch.search import (
    DISPATCH_COUNTS,
    SERVE_EVENTS,
    Index,
    QueueFull,
    SearchServer,
    SearchSpec,
    ServeConfig,
    VirtualClock,
    plan_buckets,
    reset_serve_events,
)
from repro_torch.testing import assert_topk_close

K = 10
D = 16


def _db(seed=1, n=2048):
    return np.random.default_rng(seed).standard_normal((n, D), dtype=np.float32)


@pytest.fixture(scope="module")
def index():
    return Index.build(_db(), metric="mips", k=K, backend="torch", device="cpu")


@pytest.fixture(autouse=True)
def _reset_counters():
    DISPATCH_COUNTS.clear()
    reset_serve_events()
    yield


def _vserver(index, **cfg):
    cfg.setdefault("max_batch", 32)
    return SearchServer(index, ServeConfig(**cfg), clock=VirtualClock())


def _queries(seed, m):
    return np.random.default_rng(seed).standard_normal((m, D), dtype=np.float32)


def _same(direct, served):
    """A served result against a direct search of the same rows (the
    module docstring says why not bit for bit on the CPU)."""
    assert served.values.shape == direct.values.shape
    assert_topk_close(direct.values.numpy(), direct.indices.numpy(),
                      served.values.numpy(), served.indices.numpy())


# --- coalescing: one dispatch, the direct search's results ------------------


def test_coalesced_micro_batch_is_one_dispatch(index):
    server = _vserver(index)
    server.precompile()
    DISPATCH_COUNTS.clear()
    reset_serve_events()
    sizes = [3, 5, 8, 4]  # 20 rows -> one bucket-32 micro-batch
    qs = [_queries(10 + i, m) for i, m in enumerate(sizes)]
    tickets = [server.submit(q) for q in qs]
    server.run_until_idle()
    assert DISPATCH_COUNTS["torch"] == 1, dict(DISPATCH_COUNTS)
    assert SERVE_EVENTS["batches"] == 1
    assert SERVE_EVENTS["coalesced_requests"] == len(sizes)
    assert SERVE_EVENTS["eager_batches"] == 1  # no graphs on the CPU
    for q, t in zip(qs, tickets):
        got = t.result()
        assert isinstance(got.values, torch.Tensor) and got.values.device.type == "cpu"
        _same(index.search(q), got)


def test_dispatch_count_equals_micro_batch_count(index):
    server = _vserver(index)
    server.precompile()
    DISPATCH_COUNTS.clear()
    tickets = [server.submit(_queries(50 + i, 8)) for i in range(12)]  # 96 rows
    server.run_until_idle()
    batches = server.stats()["batches"]
    assert batches == 3
    assert DISPATCH_COUNTS["torch"] == batches
    assert all(t.done for t in tickets)


def test_fifo_whole_request_coalescing(index):
    server = _vserver(index, max_batch=24)
    for m in (10, 10, 10):
        server.submit(_queries(3, m))
    assert server.step()      # batch 1: 10 + 10 = 20 <= 24
    assert server.step()      # batch 2: the remaining 10
    assert not server.step()  # queue empty
    s = server.stats()
    assert (s["batches"], s["coalesced_requests"], s["dispatched_rows"]) == (2, 3, 30)


def test_per_request_k_budgets_share_one_dispatch(index):
    server = _vserver(index)
    q = _queries(21, 6)
    t1, t3, tk = server.submit(q, k=1), server.submit(q, k=3), server.submit(q)
    server.run_until_idle()
    assert DISPATCH_COUNTS["torch"] == 1
    full = tk.result()
    _same(index.search(q), full)
    for t, kk in ((t1, 1), (t3, 3)):
        vals, idxs = t.result()
        assert vals.shape == idxs.shape == (6, kk)
        assert torch.equal(idxs, full.indices[:, :kk])  # one dispatch, sliced
        assert torch.equal(vals, full.values[:, :kk])
    with pytest.raises(ValueError, match="per-request k"):
        server.submit(q, k=K + 1)


def test_single_row_request_and_shapes(index):
    server = _vserver(index)
    t = server.submit(_queries(33, 1)[0])  # a bare (D,) row is promoted
    server.run_until_idle()
    vals, idxs = t.result()
    assert vals.shape == idxs.shape == (1, K)
    with pytest.raises(ValueError, match="dim"):
        server.submit(np.zeros((2, D + 1), np.float32))


def test_server_rejects_unsorted_candidate_specs():
    raw = Index.build(_db(4, 256), spec=SearchSpec(k=4, backend="torch",
                                                   aggregate_to_topk=False),
                      device="cpu")
    with pytest.raises(ValueError, match="aggregate_to_topk"):
        SearchServer(raw, clock=VirtualClock())


# --- admission / backpressure ------------------------------------------------


def test_backpressure_bounds_queue_depth(index):
    server = _vserver(index, max_pending_rows=16)
    for _ in range(4):
        server.submit(_queries(7, 4))
    assert server.pending_rows == 16
    with pytest.raises(QueueFull):
        server.submit(_queries(7, 1))
    assert server.stats()["peak_pending_rows"] <= 16
    server.step()
    server.submit(_queries(8, 4))
    server.run_until_idle()
    assert server.pending_rows == 0
    with pytest.raises(QueueFull, match="admission capacity"):
        server.submit(_queries(9, 17))


def test_virtual_clock_latency_accounting(index):
    clock = VirtualClock()
    server = SearchServer(index, ServeConfig(max_batch=32), clock=clock)
    t0 = server.submit(_queries(40, 4))
    clock.advance(0.5)
    t1 = server.submit(_queries(41, 4))
    clock.advance(0.25)
    server.run_until_idle()
    assert t0.latency_s == pytest.approx(0.75)
    assert t1.latency_s == pytest.approx(0.25)


# --- buckets -----------------------------------------------------------------


def test_planner_derives_bucket_ladder(index):
    assert index.spec.serve_buckets == plan_buckets(index.spec.query_block)
    assert _vserver(index, max_batch=64).buckets == (8, 16, 32, 64)
    assert _vserver(index, max_batch=64, buckets=(4, 12)).buckets == (4, 12, 64)


def test_cpu_server_has_no_graphs(index):
    """The CPU has no CUDA graphs: every batch is eager, the index's graph
    cache stays empty, and asking for a graph raises."""
    server = _vserver(index, buckets=(8, 16, 32))
    server.precompile()
    for i in range(3):
        server.submit(_queries(60 + i, 1 + 5 * i))
    server.run_until_idle()
    s = server.stats()
    assert s["graph_replays"] == 0 and s["eager_batches"] == s["batches"] == 1
    assert s["cache"]["entries"] == s["cache"]["captures"] == 0
    with pytest.raises(RuntimeError, match="CUDA graphs"):
        index.search_graph(8)


def test_oversize_request_is_searched_eagerly():
    oversize = Index.build(_db(2, 1024), metric="l2", k=K, backend="torch",
                           device="cpu", query_block=16)
    server = SearchServer(oversize, ServeConfig(max_batch=16, max_pending_rows=512),
                          clock=VirtualClock())
    q = _queries(60, 40)          # 40 rows > max_batch -> solo batch,
    t = server.submit(q)          # padded to 64 = 16 * 2**2
    server.submit(_queries(61, 4))  # next batch, proves no starvation
    server.run_until_idle()
    assert server.stats()["oversize_batches"] == 1
    assert all(b <= server.max_batch for b in server._staging)
    _same(oversize.search(q), t.result())
    DISPATCH_COUNTS.clear()
    server.submit(q)
    server.run_until_idle()
    # the plain path streams query_block rows a dispatch: 64 / 16
    assert DISPATCH_COUNTS["torch"] == 4


def test_double_buffered_staging_reuses_two_slots(index):
    server = _vserver(index)
    for i in range(4):
        server.submit(_queries(70 + i, 20))  # one 32-bucket batch each
    server.run_until_idle()
    assert server.stats()["staging_swaps"] == 4
    assert list(server._staging) == [32] and len(server._staging[32]) == 2
    q = _queries(71, 20)
    t = server.submit(q)
    server.run_until_idle()
    _same(index.search(q), t.result())


# --- wall-clock mode ---------------------------------------------------------


def test_wall_clock_mode_end_to_end(index):
    server = SearchServer(index, ServeConfig(max_batch=32, max_delay_s=0.001))
    results, errors = {}, []

    def client(cid):
        try:
            q = _queries(100 + cid, 1 + cid % 5)
            results[cid] = (q, server.submit(q).result(timeout=60))
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not any(th.is_alive() for th in threads)
    server.close(timeout=30)
    assert not errors and len(results) == 16
    for q, res in results.values():
        _same(index.search(q), res)
    assert server.stats()["batches"] <= 16
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(_queries(0, 1))


def test_wall_clock_mutation_gate():
    """Adds and deletes from the caller's thread while the worker serves:
    ``mutation()`` serializes them, every request completes, and what was
    added is searchable and what was deleted never returns."""
    ix = Index.build(_db(8, 512), metric="mips", k=4, capacity=2048,
                     backend="torch", device="cpu")
    server = SearchServer(ix, ServeConfig(max_batch=32, max_delay_s=0.0))
    stop = threading.Event()
    errors, served = [], []

    def client(cid):
        try:
            while not stop.is_set():
                served.append(server.submit(_queries(cid, 4)).result(timeout=60))
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    for th in threads:
        th.start()
    try:
        for i in range(8):
            with server.mutation():
                ix.add(_queries(200 + i, 16))
                ix.delete([i])
    finally:
        stop.set()
        for th in threads:
            th.join(60)
        server.close(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert not errors and served
    assert len(ix) == 512 + 8 * 16 - 8
    probe = _queries(207, 16)
    got = server.index.search(probe)
    assert not set(got.indices.numpy().ravel().tolist()) & set(range(8))


# --- fault-tolerance surface ------------------------------------------------


def test_deadline_request_completes_within_budget(index):
    server = SearchServer(index, ServeConfig(max_batch=32), clock=VirtualClock())
    q = _queries(90, 4)
    t = server.submit(q, deadline_s=10.0)
    server.run_until_idle()
    _same(index.search(q), t.result())
    assert server.stats()["deadline_expired"] == 0
    server.close()


def test_health_on_a_clean_server(index):
    server = _vserver(index)
    h = server.health()
    assert h["status"] == "ok"
    assert h["worker_alive"] and not h["closed"]
    assert h["pending_rows"] == 0
    assert "cluster_miss" not in h
    server.submit(_queries(91, 4)).result()
    assert server.health()["failed_batches"] == 0
    server.close()


def test_stats_include_failure_taxonomy_counters(index):
    s = _vserver(index).stats()
    for key in ("deadline_expired", "transient_faults", "dispatch_retries",
                "worker_deaths", "worker_restarts", "requeued_tickets",
                "load_shed", "miss_sampled_rows", "graph_replays"):
        assert s[key] == 0, key


def test_clustered_index_serves_and_samples_misses():
    """A clustered index (a mixture corpus) is served through the pruned
    path; the served-query miss monitor samples every batch here and
    reports in ``health()``."""
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((16, D)).astype(np.float32) * 2.5
    db = centers[rng.integers(0, 16, 12_000)] + rng.standard_normal(
        (12_000, D), dtype=np.float32)
    ix = Index.build(db, metric="l2", k=K, device="cpu")
    assert ix.pack().cluster is not None
    server = _vserver(ix, miss_sample_every=1)
    q = centers[rng.integers(0, 16, 6)] + rng.standard_normal((6, D),
                                                              dtype=np.float32)
    t = server.submit(q)
    server.run_until_idle()
    _same(ix.search(q), t.result())
    assert server.stats()["miss_sampled_rows"] == 6
    assert "cluster_miss" in server.health()


# --- parity with the reference ----------------------------------------------


def _stream(seed, waves=6):
    rng = np.random.default_rng(seed)
    out = []
    for w in range(waves):
        wave = [(_queries(1000 + 10 * w + r, int(rng.integers(1, 13))),
                 int(rng.integers(1, K + 1)))
                for r in range(int(rng.integers(1, 6)))]
        out.append((wave, float(rng.uniform(0.0, 0.3))))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_request_stream_matches_reference(seed):
    """The same stream on a virtual clock: the reference's batches,
    coalesced requests, dispatched and padded rows, the same latencies,
    and per-ticket results equal to the reference's (indices equal except
    at its own ties)."""
    db = _db()
    ours = Index.build(db, metric="l2", k=K, backend="torch", device="cpu")
    ref = RefIndex.build(jnp.asarray(db), metric="l2", k=K, backend="xla")
    cfg = dict(max_batch=32, buckets=(8, 16, 32))
    srv, rsrv = (SearchServer(ours, ServeConfig(**cfg), clock=VirtualClock()),
                 RefServer(ref, RefConfig(**cfg), clock=RefClock()))
    tickets = []
    for wave, dt in _stream(seed):
        for q, k in wave:
            tickets.append((srv.submit(q, k=k), rsrv.submit(q, k=k)))
        srv._clock.advance(dt)
        rsrv._clock.advance(dt)
        assert srv.step() == rsrv.step()
    srv.run_until_idle()
    rsrv.run_until_idle()
    keys = ("batches", "coalesced_requests", "completed_requests",
            "dispatched_rows", "padded_rows", "staging_swaps",
            "oversize_batches")
    a, b = srv.stats(), rsrv.stats()
    assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
    assert a["occupancy"] == b["occupancy"]
    for t, rt in tickets:
        assert t.latency_s == pytest.approx(rt.latency_s)
        (v, i), (rv, ri) = t.result(), rt.result()
        assert v.shape == rv.shape
        assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(), i.numpy())
    srv.close()
    rsrv.close()
