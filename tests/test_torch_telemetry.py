"""``repro_torch.search.telemetry`` against ``repro.search.telemetry``, on
the CPU.

The port of ``tests/test_telemetry.py`` (registry, request traces, the
drift monitor, thread safety, the exported series of a served workload),
and parity with the reference: the same registry calls export the same
Prometheus text and JSON, and the same drift records and traces give the
same reports.
"""
import threading
import time

import numpy as np
import pytest

from repro.search import telemetry as ref_telemetry
from repro_torch.kernels import partial_reduce as prk
from repro_torch.search import (
    DISPATCH_COUNTS,
    PACK_EVENTS,
    SERVE_EVENTS,
    AtomicCounter,
    DriftMonitor,
    Index,
    MetricsRegistry,
    RequestTrace,
    SearchServer,
    ServeConfig,
    VirtualClock,
    chrome_trace,
    telemetry,
    trace_coverage,
)
from repro_torch.search.faults import DelayFault, FatalFault, FaultInjector

K = 10
D = 16


@pytest.fixture(scope="module")
def index():
    db = np.random.default_rng(1).standard_normal((2048, D), dtype=np.float32)
    return Index.build(db, metric="mips", k=K, backend="torch", device="cpu")


@pytest.fixture(autouse=True)
def _reset_telemetry():
    telemetry.reset_all()
    yield
    telemetry.reset_all()


def _vserver(index, **cfg):
    cfg.setdefault("max_batch", 32)
    return SearchServer(index, ServeConfig(**cfg), clock=VirtualClock())


def _queries(seed, m):
    return np.random.default_rng(seed).standard_normal((m, D), dtype=np.float32)


# --- metrics registry --------------------------------------------------------


def test_registry_counters_gauges_labels():
    reg = MetricsRegistry()
    reg.inc("req_total", backend="cuda")
    reg.inc("req_total", 2, backend="torch")
    reg.inc("req_total", backend="cuda")
    assert reg.counter_value("req_total", backend="cuda") == 2
    assert reg.counter_value("req_total", backend="torch") == 2
    assert reg.counter_value("req_total", backend="host") == 0
    reg.set_gauge("depth", 7, tier="hot")
    reg.set_gauge("depth", 3, tier="hot")
    assert reg.gauge_value("depth", tier="hot") == 3
    assert reg.gauge_value("depth", tier="cold") is None


def test_registry_histogram_quantiles_and_window():
    reg = MetricsRegistry()
    values = list(range(1, 101))
    for v in values:
        reg.observe("lat", v)
    snap = reg.histogram_snapshot("lat")
    assert (snap["count"], snap["sum"]) == (100, sum(values))
    for q in (50, 90, 99):
        assert snap[f"p{q}"] == pytest.approx(np.percentile(values, q))
    small = MetricsRegistry(histogram_window=8)
    for v in range(100):
        small.observe("lat", v)
    snap = small.histogram_snapshot("lat")
    assert (snap["count"], snap["window"], snap["min"]) == (100, 8, 92)


def _drive_registry(module):
    """The same calls on a registry of ``module``."""
    reg = module.MetricsRegistry(histogram_window=16)
    legacy = module.AtomicCounter()
    reg.register_counter_dict("legacy_total", legacy, "event", "adopted dict")
    reg.describe("repro_req_total", "requests")
    reg.inc("repro_req_total", 3, backend="cuda", storage="int8")
    reg.inc("repro_req_total", backend="torch", storage="f32")
    reg.set_gauge("repro_depth", 5)
    reg.set_gauge("repro_occupancy", 0.625, bucket=32)
    for v in (0.25, 0.5, 1.5, 3.0, 0.125):
        reg.observe("repro_lat_seconds", v)
        reg.observe("repro_rows", v * 8, bucket=16)
    legacy.inc("hit", 4)
    legacy.inc("miss")
    return reg


def test_exports_equal_reference():
    ours, ref = _drive_registry(telemetry), _drive_registry(ref_telemetry)
    assert ours.export_prometheus() == ref.export_prometheus()
    assert ours.export_json() == ref.export_json()
    text = ours.export_prometheus()
    assert 'repro_req_total{backend="cuda",storage="int8"} 3' in text
    assert 'repro_lat_seconds{quantile="0.5"} 0.5' in text
    assert 'legacy_total{event="hit"} 4' in text
    ours.reset()
    assert "legacy_total{" not in ours.export_prometheus()


def test_drift_and_traces_equal_reference():
    reports = []
    for module in (telemetry, ref_telemetry):
        mon = module.DriftMonitor(band=(0.5, 2.0), warmup=2, alpha=0.5)
        for bucket, m, p in (("8", 1e-3, 1e-4), ("8", 1.2e-3, 1e-4),
                             ("32", 2e-3, 5e-4), ("8", 9e-3, 1e-4),
                             ("32", 2.1e-3, 5e-4), ("32", 2e-3, 5e-4)):
            mon.record(bucket, m, p)
        tr = module.RequestTrace(1, 4, 10, 0.0)
        for name, a, b in (("queue", 0.0, 0.5), ("dispatch", 0.5, 0.7),
                           ("scatter", 0.6, 1.0)):
            tr.span(name, a, b)
        tr.completed_at = 1.0
        reports.append((mon.report(), module.trace_coverage([tr]),
                        module.chrome_trace([tr])))
    assert reports[0] == reports[1]


def test_port_counters_are_adopted():
    DISPATCH_COUNTS.inc("cuda")
    PACK_EVENTS.inc("full_pack")
    prk.LAUNCHES.inc("partial_reduce_fused")
    prk.PLAIN_CALLS.inc("fused_carry_merge")
    SERVE_EVENTS.inc("graph_replays")
    text = telemetry.export_prometheus()
    for line in ('repro_dispatches_total{backend="cuda"} 1',
                 'repro_pack_events_total{event="full_pack"} 1',
                 'repro_kernel_launches_total{kernel="partial_reduce_fused"} 1',
                 'repro_kernel_plain_calls_total{kernel="fused_carry_merge"} 1',
                 'repro_serve_events_total{event="graph_replays"} 1'):
        assert line in text, line
    telemetry.reset_all()
    for counter in (DISPATCH_COUNTS, PACK_EVENTS, prk.LAUNCHES,
                    prk.PLAIN_CALLS, SERVE_EVENTS):
        assert dict(counter) == {}


# --- thread safety -----------------------------------------------------------


def test_counters_are_exact_under_contention():
    c, reg = AtomicCounter(), MetricsRegistry()
    threads, per = 8, 2000

    def hammer():
        for _ in range(per):
            c.inc("hits")
            reg.inc("total", event="x")

    ts = [threading.Thread(target=hammer) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)
    assert c["hits"] == threads * per
    assert reg.counter_value("total", event="x") == threads * per


def test_wall_clock_server_counters_exact_with_concurrent_readers(index):
    server = SearchServer(index, ServeConfig(max_batch=32, max_delay_s=0.001),
                          warmup=True)
    clients, per = 4, 25
    stop = threading.Event()
    errors = []

    def reader():
        while not stop.is_set():
            server.stats()
            server.health()
            telemetry.export_prometheus()
            dict(SERVE_EVENTS)

    def client(cid):
        try:
            q = _queries(100 + cid, 4)
            for _ in range(per):
                server.submit(q).result(timeout=60)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    rd = threading.Thread(target=reader)
    rd.start()
    ts = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    stop.set()
    rd.join(60)
    assert not any(t.is_alive() for t in ts + [rd])
    assert not errors
    s = server.stats()
    assert s["completed_requests"] == s["coalesced_requests"] == clients * per
    assert SERVE_EVENTS["coalesced_requests"] == clients * per
    server.close(timeout=30)


# --- per-request tracing -----------------------------------------------------


def test_virtual_clock_span_timings_are_deterministic(index):
    clock = VirtualClock()
    server = SearchServer(index, ServeConfig(max_batch=32), clock=clock)
    t = server.submit(_queries(7, 4))
    clock.advance(0.25)
    server.run_until_idle()
    (tr,) = server.traces()
    assert tr.status == "done"
    assert t.latency_s == pytest.approx(0.25)
    spans = {s.name: s for s in tr.spans}
    assert set(spans) == {"submit", "queue", "coalesce", "stage", "dispatch",
                          "scatter"}
    assert spans["queue"].start == pytest.approx(0.0)
    assert spans["queue"].duration_s == pytest.approx(0.25)
    for name in ("coalesce", "stage", "dispatch", "scatter"):
        assert spans[name].duration_s == pytest.approx(0.0)
        assert spans[name].start == pytest.approx(0.25)
    assert tr.covered_s() == pytest.approx(tr.duration_s)
    assert trace_coverage([tr]) == pytest.approx(1.0)
    assert isinstance(tr, RequestTrace)
    server.close()


def test_trace_ring_buffer_and_failure(index):
    server = _vserver(index, trace_buffer=4)
    tickets = [server.submit(_queries(20 + i, 2)) for i in range(10)]
    server.run_until_idle()
    assert all(t.done for t in tickets)
    traces = server.traces()
    assert len(traces) == 4
    ids = [tr.trace_id for tr in traces]
    assert ids == sorted(ids)
    assert server.traces(2) == traces[-2:]
    inj = FaultInjector(schedule=[("serve.dispatch", 1, "fatal")])
    failing = SearchServer(index, ServeConfig(max_batch=32),
                           clock=VirtualClock(), faults=inj)
    t = failing.submit(_queries(9, 4))
    failing.run_until_idle()
    with pytest.raises(FatalFault):
        t.result()
    (tr,) = failing.traces()
    assert tr.status == "failed" and any(s.name == "failed" for s in tr.spans)


def test_chrome_trace_export_shape(index):
    server = _vserver(index)
    server.submit(_queries(11, 4))
    server.run_until_idle()
    doc = chrome_trace(server.traces())
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in xs} >= {"queue", "dispatch", "scatter"}
    for e in xs:
        assert e["cat"] == "serve" and e["dur"] >= 0 and e["args"]["rows"] == 4
    assert any(e.get("ph") == "M" for e in doc["traceEvents"])


def test_tracing_off_changes_no_counter_or_result(index):
    q = _queries(13, 8)

    def run(trace_buffer):
        telemetry.reset_all()
        server = _vserver(index, trace_buffer=trace_buffer)
        server.precompile()
        DISPATCH_COUNTS.clear()
        t = server.submit(q)
        server.run_until_idle()
        vals, idxs = t.result()
        counts = dict(DISPATCH_COUNTS)
        n_traces = len(server.traces())
        server.close()
        return vals, idxs, counts, n_traces

    v_on, i_on, c_on, n_on = run(256)
    v_off, i_off, c_off, n_off = run(0)
    assert c_on == c_off and (n_on, n_off) == (1, 0)
    assert np.array_equal(v_on.numpy(), v_off.numpy())
    assert np.array_equal(i_on.numpy(), i_off.numpy())


# --- roofline-drift monitor --------------------------------------------------


def test_drift_monitor_calibrates_then_degrades():
    mon = DriftMonitor(band=(0.5, 2.0), warmup=2, alpha=1.0)
    r = mon.report()
    assert not r["calibrated"] and r["value"] == 1.0 and r["in_band"]
    mon.record("32", 1e-3, 1e-4)
    mon.record("32", 1e-3, 1e-4)
    r = mon.report()
    assert r["calibrated"] and r["value"] == pytest.approx(1.0) and r["in_band"]
    mon.record("32", 1e-2, 1e-4)
    r = mon.report()
    assert r["value"] == pytest.approx(10.0) and not r["in_band"]


def test_delay_fault_is_slow_but_successful():
    inj = FaultInjector(schedule=[("serve.dispatch", 1, "delay")], delay_s=0.02)
    t0 = time.perf_counter()
    inj.fire("serve.dispatch")  # must NOT raise
    assert time.perf_counter() - t0 >= 0.02
    assert inj.fired["serve.dispatch"] == 1
    assert issubclass(DelayFault, Exception)


def test_injected_slow_dispatch_degrades_health(index):
    """Clean batches calibrate the drift baseline; two delayed dispatches
    (0.1 s more each, far above a clean one's wall even on a loaded host)
    then leave the band, and health flips to degraded."""
    warm = 4
    inj = FaultInjector(
        schedule=[("serve.dispatch", h, "delay") for h in (warm + 1, warm + 2)],
        delay_s=0.1,
    )
    server = SearchServer(
        index, ServeConfig(max_batch=32, drift_warmup=3, drift_alpha=1.0,
                           drift_band=(0.5, 2.0)),
        clock=VirtualClock(), faults=inj,
    )
    server.precompile()
    for i in range(warm):
        server.submit(_queries(50 + i, 4))
        server.run_until_idle()
    h = server.health()
    assert h["drift"]["calibrated"] and h["drift"]["in_band"]
    assert h["status"] == "ok"
    for i in range(2):
        server.submit(_queries(60 + i, 4))
        server.run_until_idle()
    h = server.health()
    assert not h["drift"]["in_band"] and h["status"] == "degraded"
    assert inj.fired["serve.dispatch"] == 2
    server.close()


def test_health_reports_uptime_last_fault_and_recall(index):
    clock = VirtualClock()
    inj = FaultInjector(schedule=[("serve.dispatch", 1, "fatal")])
    server = SearchServer(index, ServeConfig(max_batch=32), clock=clock,
                          faults=inj)
    assert server.health()["last_fault"] is None
    clock.advance(2.0)
    assert server.health()["uptime_s"] == pytest.approx(2.0)
    t = server.submit(_queries(70, 4))
    server.run_until_idle()
    with pytest.raises(FatalFault):
        t.result()
    h = server.health()
    assert h["last_fault"]["error"] == "FatalFault"
    assert h["last_fault"]["point"] == "serve.dispatch"
    assert h["expected_recall_live"] == pytest.approx(
        float(index.plan.expected_recall))
    server.close()


# --- end-to-end export surface -----------------------------------------------


def test_server_workload_exports_expected_series(index):
    server = _vserver(index)
    for i in range(3):
        server.submit(_queries(80 + i, 4))
    server.run_until_idle()
    server.health()
    snapshot = index.telemetry()
    text = telemetry.export_prometheus()
    for series in ("repro_dispatches_total", "repro_serve_events_total",
                   "repro_serve_request_latency_seconds",
                   "repro_serve_batch_rows", "repro_serve_uptime_seconds",
                   "repro_serve_dispatch_wall_seconds", "repro_index_size",
                   "repro_index_expected_recall_live"):
        assert series in text, series
    assert 'repro_index_size{backend="torch",cluster="off",storage="f32"} 2048' \
        in text
    assert snapshot["counters"]["repro_dispatches_total"]
    assert snapshot["histograms"]["repro_serve_request_latency_seconds"]
    server.close()
