"""``repro_torch.search.faults`` and the server's recovery paths, on the CPU.

The port of ``tests/test_faults.py`` (its snapshot cases are in
``tests/test_torch_snapshot.py``; the datastore case waits for ROADMAP
queue A item 12), and parity with the reference: an injector with the
same seed, rates and schedule fires at the same hits in both packages.
Everything but the wall-clock watchdog tests runs on the virtual clock.
"""
import numpy as np
import pytest

from repro.search import faults as ref_faults
from repro_torch.search import (
    DISPATCH_COUNTS,
    PACK_EVENTS,
    SERVE_EVENTS,
    DeadlineExceeded,
    Index,
    Overloaded,
    QueueFull,
    SearchServer,
    ServeConfig,
    VirtualClock,
    faults,
    reset_serve_events,
)
from repro_torch.search.faults import (
    FatalFault,
    FaultInjector,
    TransientFault,
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
    PACK_EVENTS.clear()
    yield
    faults.uninstall()  # never leak an injector into another test


def _vserver(index, inj=None, clock=None, **cfg):
    cfg.setdefault("max_batch", 32)
    return SearchServer(
        index, ServeConfig(**cfg), clock=clock or VirtualClock(), faults=inj
    )


def _queries(seed, m):
    return np.random.default_rng(seed).standard_normal((m, D), dtype=np.float32)


def _same(index, q, served):
    direct = index.search(q)
    assert_topk_close(direct.values.numpy(), direct.indices.numpy(),
                      served.values.numpy(), served.indices.numpy())


# --- the injector itself -----------------------------------------------------


def test_schedule_fires_exactly_the_nth_hit():
    inj = FaultInjector(schedule=[("serve.dispatch", 3, "fatal")])
    inj.fire("serve.dispatch")
    inj.fire("serve.dispatch")
    with pytest.raises(FatalFault) as e:
        inj.fire("serve.dispatch")
    assert (e.value.point, e.value.hit) == ("serve.dispatch", 3)
    inj.fire("serve.dispatch")
    assert inj.hits["serve.dispatch"] == 4
    assert inj.fired["serve.dispatch"] == 1


def test_rate_based_firing_is_deterministic_across_reset():
    inj = FaultInjector(seed=7, rates={"serve.dispatch": 0.3})

    def pattern(n=200):
        fired = []
        for i in range(n):
            try:
                inj.fire("serve.dispatch")
            except TransientFault:
                fired.append(i)
        return fired

    first = pattern()
    assert first
    inj.reset()
    assert pattern() == first
    twin = FaultInjector(seed=7, rates={"serve.dispatch": 0.3,
                                        "serve.transfer": 0.3})
    fired = []
    for i in range(200):
        try:
            twin.fire("serve.dispatch")
        except TransientFault:
            fired.append(i)
        if i % 3 == 0:  # extra traffic on another point
            try:
                twin.fire("serve.transfer")
            except TransientFault:
                pass
    assert fired == first


def test_injector_validates_points_and_kinds():
    with pytest.raises(ValueError, match="unknown injection point"):
        FaultInjector(rates={"serve.nope": 0.5})
    with pytest.raises(ValueError, match="unknown injection point"):
        FaultInjector(schedule=[("bogus", 1, "fatal")])
    with pytest.raises(ValueError, match="kind"):
        FaultInjector(schedule=[("serve.dispatch", 1, "oops")])
    with pytest.raises(ValueError, match="1-based"):
        FaultInjector(schedule=[("serve.dispatch", 0, "fatal")])
    with pytest.raises(ValueError, match="rate"):
        FaultInjector(rates={"serve.dispatch": 1.5})
    with pytest.raises(ValueError, match="unknown injection point"):
        FaultInjector().fire("nope")


def test_global_registry_scoping():
    assert faults.active() is None
    faults.fire("serve.worker")  # no-op without an injector
    with faults.injected(FaultInjector()) as inj:
        assert faults.active() is inj
        with faults.injected(FaultInjector()) as inner:
            assert faults.active() is inner
        assert faults.active() is inj
    assert faults.active() is None


def _fired_hits(module, seed, kind, n=1000):
    """Per point, the hits (1-based) at which an injector of ``module``
    fires over ``n`` hits of every point, interleaved."""
    inj = module.FaultInjector(
        seed=seed, rates={p: 0.1 + 0.05 * i
                          for i, p in enumerate(module.INJECTION_POINTS)},
        schedule=[("serve.worker", 7, "death"), ("index.save", 500, "fatal")],
        rate_kind=kind, delay_s=0.0,
    )
    out = {p: [] for p in module.INJECTION_POINTS}
    for _ in range(n):
        for p in module.INJECTION_POINTS:
            before = inj.fired[p]
            try:
                inj.fire(p)
            except module.InjectedFault as e:
                out[p].append((e.hit, type(e).__name__))
                continue
            if inj.fired[p] != before:  # a delay fired without raising
                out[p].append((inj.hits[p], "delay"))
    return out


@pytest.mark.parametrize("seed,kind", [(0, "transient"), (7, "fatal"),
                                       (123, "delay")])
def test_injector_fires_at_the_reference_hits(seed, kind):
    assert faults.INJECTION_POINTS == ref_faults.INJECTION_POINTS
    ours = _fired_hits(faults, seed, kind)
    ref = _fired_hits(ref_faults, seed, kind)
    assert ours == ref
    assert all(ours[p] for p in faults.INJECTION_POINTS)


# --- retries: transient dispatch faults --------------------------------------


def test_transient_dispatch_fault_is_retried(index):
    q = _queries(10, 6)
    inj = FaultInjector(schedule=[("serve.dispatch", 1, "transient")])
    server = _vserver(index, inj)
    server.precompile()
    DISPATCH_COUNTS.clear()
    got = server.submit(q).result()
    s = server.stats()
    assert (s["transient_faults"], s["dispatch_retries"], s["failed_batches"]) \
        == (1, 1, 0)
    assert SERVE_EVENTS["dispatch_retries"] == 1
    # the fault fired BEFORE the dispatch: one batch -> one dispatch
    assert DISPATCH_COUNTS["torch"] == 1, dict(DISPATCH_COUNTS)
    _same(index, q, got)
    server.close()


def test_exhausted_retries_surface_the_typed_error(index):
    inj = FaultInjector(rates={"serve.dispatch": 1.0})
    server = _vserver(index, inj, max_dispatch_retries=2)
    t = server.submit(_queries(11, 4))
    with pytest.raises(TransientFault):
        t.result()
    s = server.stats()
    assert (s["transient_faults"], s["dispatch_retries"], s["failed_batches"]) \
        == (3, 2, 1)
    server.close()


def test_fatal_fault_fails_fast_without_retry(index):
    inj = FaultInjector(schedule=[("serve.dispatch", 1, "fatal")])
    server = _vserver(index, inj)
    with pytest.raises(FatalFault):
        server.submit(_queries(12, 4)).result()
    assert server.stats()["dispatch_retries"] == 0
    q = _queries(13, 4)
    _same(index, q, server.submit(q).result())
    server.close()


@pytest.mark.parametrize(
    "point", ["serve.staging_alloc", "serve.transfer", "serve.scatter"]
)
def test_pipeline_stage_faults_fail_with_typed_errors(index, point):
    inj = FaultInjector(schedule=[(point, 1, "fatal")])
    server = _vserver(index, inj)
    t = server.submit(_queries(14, 4))
    if point == "serve.scatter":
        server.run_until_idle()
    with pytest.raises(FatalFault) as e:
        t.result()
    assert e.value.point == point
    server.close()


# --- deadlines ---------------------------------------------------------------


def test_expired_ticket_is_never_dispatched(index):
    clock = VirtualClock()
    server = _vserver(index, clock=clock)
    server.precompile()
    DISPATCH_COUNTS.clear()
    t = server.submit(_queries(20, 4), deadline_s=0.5)
    clock.advance(1.0)
    with pytest.raises(DeadlineExceeded):
        t.result()
    assert sum(DISPATCH_COUNTS.values()) == 0, dict(DISPATCH_COUNTS)
    assert server.stats()["deadline_expired"] == 1
    assert SERVE_EVENTS["deadline_expired"] == 1
    assert server.pending_rows == 0
    server.close()


def test_mixed_expired_and_live_batch(index):
    clock = VirtualClock()
    server = _vserver(index, clock=clock)
    dead = server.submit(_queries(21, 4), deadline_s=0.5)
    clock.advance(1.0)
    q = _queries(22, 4)
    live = server.submit(q, deadline_s=10.0)
    server.run_until_idle()
    with pytest.raises(DeadlineExceeded):
        dead.result()
    _same(index, q, live.result())
    server.close()


def test_deadline_expires_during_retry_backoff(index):
    clock = VirtualClock()
    inj = FaultInjector(rates={"serve.dispatch": 1.0})
    server = _vserver(index, inj, clock=clock, max_dispatch_retries=5,
                      retry_backoff_s=0.4)
    server.precompile()
    DISPATCH_COUNTS.clear()
    t = server.submit(_queries(23, 4), deadline_s=1.0)
    with pytest.raises(DeadlineExceeded):
        t.result()
    assert sum(DISPATCH_COUNTS.values()) == 0
    assert server.stats()["dispatch_retries"] < 5
    server.close()


def test_submit_rejects_nonpositive_deadline(index):
    server = _vserver(index)
    with pytest.raises(ValueError, match="deadline_s"):
        server.submit(_queries(24, 2), deadline_s=0.0)
    server.close()


# --- worker death / watchdog -------------------------------------------------


def test_virtual_worker_death_requeues_and_recovers(index):
    q = _queries(30, 4)
    inj = FaultInjector(schedule=[("serve.dispatch", 1, "death")])
    server = _vserver(index, inj)
    t = server.submit(q)
    _same(index, q, t.result())
    s = server.stats()
    assert (s["worker_deaths"], s["worker_restarts"], s["requeued_tickets"]) \
        == (1, 1, 1)
    assert SERVE_EVENTS["requeued_tickets"] == 1
    server.close()


def test_death_between_batches_loses_nothing(index):
    inj = FaultInjector(schedule=[("serve.worker", 1, "death")])
    server = _vserver(index, inj)
    qs = [_queries(31 + i, 3) for i in range(3)]
    tickets = [server.submit(q) for q in qs]
    server.run_until_idle()
    for q, t in zip(qs, tickets):
        _same(index, q, t.result())
    assert server.stats()["requeued_tickets"] == 0
    server.close()


def test_wall_clock_watchdog_restarts_dead_worker(index):
    q = _queries(33, 4)
    inj = FaultInjector(schedule=[("serve.dispatch", 1, "death")])
    server = SearchServer(index, ServeConfig(max_batch=32, max_delay_s=0.0),
                          faults=inj)
    _same(index, q, server.submit(q).result(timeout=60))
    assert server.stats()["worker_restarts"] == 1
    assert server.health()["worker_alive"]
    server.close(timeout=30)
    assert server.health()["status"] == "ok"


def test_worker_death_mid_mutation_gate():
    ix = Index.build(_db(40, 512), metric="mips", k=4, capacity=1024,
                     backend="torch", device="cpu")
    inj = FaultInjector(schedule=[("serve.dispatch", 1, "death")])
    server = SearchServer(ix, ServeConfig(max_batch=32, max_delay_s=0.0),
                          faults=inj)
    with server.mutation():
        t = server.submit(_queries(41, 4))
        ix.add(_queries(42, 8))
    vals, idxs = t.result(timeout=60)
    assert vals.shape == (4, 4)
    assert server.stats()["worker_deaths"] == 1
    server.close(timeout=30)


# --- overload shedding -------------------------------------------------------


def test_sustained_overload_sheds_with_retry_after(index):
    clock = VirtualClock()
    server = _vserver(index, clock=clock, max_pending_rows=8,
                      overload_grace_s=0.2)
    server.submit(_queries(50, 8))
    with pytest.raises(QueueFull) as e:
        server.submit(_queries(51, 4))
    assert not isinstance(e.value, Overloaded)
    clock.advance(0.5)
    with pytest.raises(Overloaded) as e:
        server.submit(_queries(52, 4))
    assert e.value.retry_after_s > 0 and e.value.rows_pending == 8
    assert server.health()["status"] == "overloaded"
    assert SERVE_EVENTS["load_shed"] == 1
    server.run_until_idle()
    assert server.health()["status"] == "ok"
    server.submit(_queries(53, 4))
    server.run_until_idle()
    server.close()


def test_health_reports_failure_taxonomy(index):
    inj = FaultInjector(schedule=[("serve.dispatch", 1, "transient"),
                                  ("serve.worker", 2, "death")])
    server = _vserver(index, inj)
    server.submit(_queries(54, 4)).result()
    h = server.health()
    assert h["status"] == "ok"
    assert h["worker_alive"] and not h["closed"]
    assert (h["transient_faults"], h["dispatch_retries"], h["worker_deaths"]) \
        == (1, 1, 1)
    assert h["pending_rows"] == 0 and h["queued_requests"] == 0
    for key in ("deadline_expired", "failed_batches", "load_shed",
                "requeued_tickets", "worker_restarts"):
        assert key in h
    server.close()


# --- index mutation faults ---------------------------------------------------


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_index_add_and_delete_faults_are_all_or_nothing(storage):
    ix = Index.build(_db(60, 256), metric="mips", k=4, capacity=1024,
                     storage=storage, device="cpu")
    q = _queries(62, 5)
    before = ix.search(q)
    PACK_EVENTS.clear()
    with faults.injected(FaultInjector(schedule=[("index.add", 1, "fatal")])):
        with pytest.raises(FatalFault):
            ix.add(_queries(61, 8))
        assert ix.size == 256 and ix.num_appended == 256
        assert not dict(PACK_EVENTS)  # nothing was prepared or patched
        after = ix.search(q)
        assert all(np.array_equal(a.numpy(), b.numpy())
                   for a, b in zip(before, after))
        ix.add(_queries(61, 8))  # hit 2: clean
    assert ix.size == 264
    with faults.injected(FaultInjector(schedule=[("index.delete", 1, "fatal")])):
        with pytest.raises(FatalFault):
            ix.delete([0, 1])
        assert ix.size == 264
        ix.delete([0, 1])
    assert ix.size == 262


# --- seeded chaos ------------------------------------------------------------


@pytest.mark.slow
def test_seeded_chaos_run_loses_no_tickets(index):
    """A fixed fault schedule over a request stream: every ticket ends in
    a result or a typed error; then a fault-free phase holds the
    one-dispatch contract."""
    clock = VirtualClock()
    inj = FaultInjector(
        seed=3,
        rates={"serve.dispatch": 0.15},
        schedule=[
            ("serve.worker", 2, "death"),
            ("serve.dispatch", 5, "fatal"),
            ("serve.staging_alloc", 3, "fatal"),
            ("serve.dispatch", 9, "death"),
            ("serve.scatter", 4, "fatal"),
        ],
    )
    server = _vserver(index, inj, clock=clock, max_pending_rows=4096,
                      max_dispatch_retries=2, retry_backoff_s=0.01)
    server.precompile()
    rng = np.random.default_rng(3)
    tickets = []
    for wave in range(10):
        for r in range(4):
            m = int(rng.integers(1, 9))
            deadline = None if r % 3 else float(rng.uniform(0.05, 5.0))
            q = _queries(1000 + 10 * wave + r, m)
            tickets.append((q, server.submit(q, deadline_s=deadline)))
        clock.advance(float(rng.uniform(0.0, 0.5)))
        server.run_until_idle()
    server.run_until_idle()
    ok = failed = 0
    for q, t in tickets:
        assert t.done, "chaos run left a ticket hanging"
        try:
            got = t.result()
        except (faults.InjectedFault, DeadlineExceeded):
            failed += 1
        else:
            ok += 1
            _same(index, q, got)
    assert ok + failed == len(tickets)
    assert ok > 0 and failed > 0
    assert server.pending_rows == 0

    server._faults = None
    DISPATCH_COUNTS.clear()
    reset_serve_events()
    qs = [_queries(2000 + i, 8) for i in range(4)]  # one 32-row batch
    clean = [server.submit(q) for q in qs]
    server.run_until_idle()
    served_dispatches = DISPATCH_COUNTS["torch"]
    for q, t in zip(qs, clean):
        _same(index, q, t.result())
    assert served_dispatches == 1, dict(DISPATCH_COUNTS)
    assert SERVE_EVENTS["batches"] == 1
    assert SERVE_EVENTS["failed_batches"] == 0
    server.close()
