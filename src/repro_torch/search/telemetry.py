"""Telemetry: metrics registry, request traces, roofline drift.

Port of ``src/repro/search/telemetry.py`` (the framework plays no part
in it): the one observability layer the port's serving path reports
through, with the reference's series names (``repro_serve_*``,
``repro_dispatches_total``, ``repro_index_*``, ...), so that
``docs/operations.md`` is the runbook of both packages.

  * **Metrics registry** (:class:`MetricsRegistry`, process-global via
    :func:`registry`): labeled counters, gauges and windowed histograms
    (p50/p90/p99 over a bounded sample window).  The port's counter dicts
    (``DISPATCH_COUNTS``, ``PACK_EVENTS``, the kernels' ``LAUNCHES`` and
    ``PLAIN_CALLS``, ``SERVE_EVENTS``) are :class:`AtomicCounter`
    instances adopted here (``register_counter_dict``), so one export
    carries them and one :func:`reset_all` zeroes them.  Exports:
    :func:`export_prometheus` (text exposition format, histograms as
    summaries with ``quantile=`` series) and :func:`export_json`.
  * **Request traces** (:class:`RequestTrace` / :class:`Span`): every
    ``SearchServer.submit`` gets a ticket-scoped trace of contiguous stage
    spans (``queue -> coalesce -> stage -> dispatch -> scatter``) on the
    server's clock; :func:`chrome_trace` converts them to Chrome
    ``traceEvents`` JSON and :func:`trace_coverage` reports the share of
    measured request latency the spans account for.
  * **Roofline-drift monitor** (:class:`DriftMonitor`): per bucket, the
    EWMA of measured dispatch wall over the plan's predicted wall,
    normalized by a warm-up-median baseline, so the constant offset of a
    bound (the ``"h100"`` profile's peaks) from the card's real time
    calibrates out and only drift pages an operator.

Thread-safety: the serve worker increments counters while operator
threads read and export; :class:`AtomicCounter.inc` and every registry
mutator take a lock.  Like ``repro_torch.search.faults`` this module is
a leaf (stdlib and numpy only).

>>> reg = MetricsRegistry()
>>> reg.inc("requests_total", 2, backend="cuda")
2
>>> reg.counter_value("requests_total", backend="cuda")
2
>>> for v in [1.0, 2.0, 3.0, 4.0]:
...     reg.observe("latency_s", v)
>>> reg.histogram_snapshot("latency_s")["count"]
4
>>> 'requests_total{backend="cuda"} 2' in reg.export_prometheus()
True
"""
from __future__ import annotations

import collections
import re
import threading
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "AtomicCounter",
    "DriftMonitor",
    "MetricsRegistry",
    "RequestTrace",
    "Span",
    "chrome_trace",
    "export_json",
    "export_prometheus",
    "registry",
    "reset_all",
    "trace_coverage",
]

# Histogram quantiles exported everywhere (the p50/p90/p99 the serve
# bench cross-checks against its own measured latencies).
QUANTILES: Tuple[float, ...] = (0.5, 0.9, 0.99)

_LabelKey = Tuple[Tuple[str, str], ...]


class AtomicCounter(collections.Counter):
    """A ``collections.Counter`` whose increments are atomic.

    ``counter[k] += 1`` is a read-modify-write: two threads interleaving
    it lose increments (the serve worker increments while operator
    threads export).  ``inc`` performs the same update under a lock; the
    class still *is* a Counter, so every existing read/iterate/``dict()``
    call site keeps working unchanged.

    >>> c = AtomicCounter()
    >>> c.inc("batches"), c.inc("batches", 2)
    (1, 3)
    >>> c["batches"]
    3
    """

    def __init__(self, *args, **kwargs):
        self._lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def inc(self, key, n: int = 1) -> int:
        """Atomically add ``n`` to ``key``; returns the new value."""
        with self._lock:
            value = self[key] + n
            dict.__setitem__(self, key, value)
            return value

    def clear(self) -> None:
        with self._lock:
            super().clear()


def _label_key(labels: Mapping[str, object]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _prom_labels(key: _LabelKey, extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = list(key) + list(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


class _Histogram:
    """Windowed histogram: bounded sample deque + lifetime count/sum."""

    __slots__ = ("window", "count", "sum")

    def __init__(self, maxlen: int):
        self.window: collections.deque = collections.deque(maxlen=maxlen)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.window.append(float(value))
        self.count += 1
        self.sum += float(value)

    def snapshot(self) -> dict:
        arr = np.asarray(self.window, dtype=np.float64)
        out = {"count": self.count, "sum": self.sum, "window": int(arr.size)}
        if arr.size:
            out["mean"] = float(arr.mean())
            out["min"] = float(arr.min())
            out["max"] = float(arr.max())
            for q in QUANTILES:
                out[f"p{int(q * 100)}"] = float(np.percentile(arr, q * 100))
        return out


class MetricsRegistry:
    """Labeled counters, gauges and windowed histograms with export.

    One instance is process-global (:func:`registry`); serving, packing,
    the planner and the host tier all report into it.  Every mutator is
    lock-protected (see the module docstring on the ``+=`` race), and
    legacy module-global counter dicts are *adopted* — not copied — via
    :meth:`register_counter_dict`, so exports always read their live
    values and :meth:`reset` clears them too.
    """

    def __init__(self, histogram_window: int = 4096):
        if histogram_window <= 0:
            raise ValueError(
                f"histogram_window must be positive, got {histogram_window}"
            )
        self._lock = threading.RLock()
        self._window = int(histogram_window)
        self._counters: Dict[str, Dict[_LabelKey, float]] = {}
        self._gauges: Dict[str, Dict[_LabelKey, float]] = {}
        self._histograms: Dict[str, Dict[_LabelKey, _Histogram]] = {}
        self._help: Dict[str, str] = {}
        # name -> (mapping, label_name): adopted legacy counter dicts,
        # read live at export/snapshot time.
        self._adopted: Dict[str, Tuple[Mapping, str]] = {}

    # -- mutators ------------------------------------------------------------

    def inc(self, name: str, value: float = 1, **labels) -> float:
        """Atomically add ``value`` to counter ``name`` (labeled series)."""
        key = _label_key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[key] = new = series.get(key, 0) + value
            return new

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._gauges.setdefault(name, {})[key] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one histogram sample (windowed quantiles at snapshot)."""
        key = _label_key(labels)
        with self._lock:
            series = self._histograms.setdefault(name, {})
            hist = series.get(key)
            if hist is None:
                hist = series[key] = _Histogram(self._window)
            hist.observe(value)

    def describe(self, name: str, help_text: str) -> None:
        """Attach a ``# HELP`` line to ``name`` in the Prometheus export."""
        with self._lock:
            self._help[name] = str(help_text)

    def register_counter_dict(
        self, name: str, mapping: Mapping, label: str, help_text: str = ""
    ) -> None:
        """Adopt a legacy module-global counter dict as a labeled series.

        The mapping is read *live* at export time (no double
        bookkeeping) — ``{k: v}`` becomes ``name{label="k"} v`` — and
        :meth:`reset` clears it alongside the native metrics.
        Idempotent per ``name`` (re-registration replaces).
        """
        with self._lock:
            self._adopted[name] = (mapping, str(label))
            if help_text:
                self._help[name] = help_text

    def reset(self) -> None:
        """Zero every native metric AND every adopted counter dict
        (registrations and help text survive — only values clear)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            for mapping, _ in self._adopted.values():
                mapping.clear()

    # -- readers -------------------------------------------------------------

    def counter_value(self, name: str, **labels) -> float:
        key = _label_key(labels)
        with self._lock:
            if name in self._adopted:
                mapping, label = self._adopted[name]
                if len(key) == 1 and key[0][0] == label:
                    return mapping.get(key[0][1], 0)
                return 0
            return self._counters.get(name, {}).get(key, 0)

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name, {}).get(_label_key(labels))

    def histogram_snapshot(self, name: str, **labels) -> Optional[dict]:
        with self._lock:
            hist = self._histograms.get(name, {}).get(_label_key(labels))
            return hist.snapshot() if hist is not None else None

    def _collect_locked(self) -> dict:
        counters: Dict[str, List[dict]] = {}
        for name, (mapping, label) in self._adopted.items():
            counters[name] = [
                {"labels": {label: str(k)}, "value": v}
                for k, v in sorted(mapping.items(), key=lambda kv: str(kv[0]))
            ]
        for name, series in self._counters.items():
            counters.setdefault(name, []).extend(
                {"labels": dict(key), "value": v}
                for key, v in sorted(series.items())
            )
        gauges = {
            name: [
                {"labels": dict(key), "value": v}
                for key, v in sorted(series.items())
            ]
            for name, series in self._gauges.items()
        }
        histograms = {
            name: [
                {"labels": dict(key), **hist.snapshot()}
                for key, hist in sorted(series.items())
            ]
            for name, series in self._histograms.items()
        }
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": histograms,
        }

    def export_json(self) -> dict:
        """One JSON-serializable snapshot of every series (adopted legacy
        dicts included, read live)."""
        with self._lock:
            return self._collect_locked()

    def export_prometheus(self) -> str:
        """Prometheus text exposition format.

        Counters/gauges render one line per labeled series; histograms
        render as summaries — ``name{quantile="0.5"}`` etc. plus
        ``name_count`` / ``name_sum`` — which is what a scrape config
        pointed at any HTTP wrapper around this string ingests directly.
        """
        with self._lock:
            snap = self._collect_locked()
            helps = dict(self._help)
        lines: List[str] = []

        def emit_header(name: str, mtype: str) -> None:
            if name in helps:
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} {mtype}")

        for name, entries in sorted(snap["counters"].items()):
            pname = _sanitize(name)
            emit_header(pname, "counter")
            for entry in entries:
                key = _label_key(entry["labels"])
                lines.append(
                    f"{pname}{_prom_labels(key)} {entry['value']:g}"
                )
        for name, entries in sorted(snap["gauges"].items()):
            pname = _sanitize(name)
            emit_header(pname, "gauge")
            for entry in entries:
                key = _label_key(entry["labels"])
                lines.append(
                    f"{pname}{_prom_labels(key)} {entry['value']:g}"
                )
        for name, entries in sorted(snap["histograms"].items()):
            pname = _sanitize(name)
            emit_header(pname, "summary")
            for entry in entries:
                key = _label_key(entry["labels"])
                for q in QUANTILES:
                    val = entry.get(f"p{int(q * 100)}")
                    if val is not None:
                        lines.append(
                            f"{pname}"
                            f"{_prom_labels(key, [('quantile', str(q))])}"
                            f" {val:g}"
                        )
                lines.append(
                    f"{pname}_count{_prom_labels(key)} {entry['count']:g}"
                )
                lines.append(
                    f"{pname}_sum{_prom_labels(key)} {entry['sum']:g}"
                )
        return "\n".join(lines) + "\n"


# -- per-request tracing ------------------------------------------------------


class Span:
    """One named, closed time interval on the owning server's clock."""

    __slots__ = ("name", "start", "end")

    def __init__(self, name: str, start: float, end: float):
        self.name = name
        self.start = float(start)
        self.end = max(float(end), float(start))

    @property
    def duration_s(self) -> float:
        return self.end - self.start

    def to_dict(self) -> dict:
        return {"name": self.name, "start": self.start, "end": self.end}

    def __repr__(self) -> str:
        return f"Span({self.name!r}, {self.start:.6f}->{self.end:.6f})"


class RequestTrace:
    """Ticket-scoped trace: the stage spans of one served request.

    Spans are appended by the server as the request moves through
    ``queue -> coalesce -> stage -> dispatch -> scatter``; they are
    contiguous on the server's clock (virtual-clock servers therefore
    produce *deterministic* span timings), so the union of spans covers
    the request's measured latency end to end — :func:`trace_coverage`
    over a healthy run reports ~1.0.
    """

    __slots__ = (
        "trace_id", "rows", "k", "bucket", "status", "submitted_at",
        "completed_at", "dispatched_at", "retries", "spans",
    )

    def __init__(self, trace_id: int, rows: int, k: int, submitted_at: float):
        self.trace_id = int(trace_id)
        self.rows = int(rows)
        self.k = int(k)
        self.bucket: Optional[int] = None
        self.status = "pending"
        self.submitted_at = float(submitted_at)
        self.completed_at: Optional[float] = None
        self.dispatched_at: Optional[float] = None
        self.retries = 0
        self.spans: List[Span] = []

    def span(self, name: str, start: float, end: float) -> Span:
        s = Span(name, start, end)
        self.spans.append(s)
        return s

    @property
    def duration_s(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    def covered_s(self) -> float:
        """Total span time, as a union of intervals clipped to the
        request's [submit, complete] window (overlaps never double
        count, so coverage is a true fraction)."""
        if self.completed_at is None or not self.spans:
            return 0.0
        lo, hi = self.submitted_at, self.completed_at
        ivals = sorted(
            (max(s.start, lo), min(s.end, hi))
            for s in self.spans
            if s.end > lo and s.start < hi
        )
        covered = 0.0
        cur_lo: Optional[float] = None
        cur_hi = 0.0
        for a, b in ivals:
            if cur_lo is None:
                cur_lo, cur_hi = a, b
            elif a <= cur_hi:
                cur_hi = max(cur_hi, b)
            else:
                covered += cur_hi - cur_lo
                cur_lo, cur_hi = a, b
        if cur_lo is not None:
            covered += cur_hi - cur_lo
        return covered

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "rows": self.rows,
            "k": self.k,
            "bucket": self.bucket,
            "status": self.status,
            "submitted_at": self.submitted_at,
            "completed_at": self.completed_at,
            "retries": self.retries,
            "spans": [s.to_dict() for s in self.spans],
        }


def trace_coverage(traces: Iterable[RequestTrace]) -> float:
    """Fraction of total measured request latency the spans account for
    (latency-weighted across traces; 1.0 when there is no latency)."""
    covered = 0.0
    total = 0.0
    for tr in traces:
        d = tr.duration_s
        if d is None or d <= 0:
            continue
        total += d
        covered += tr.covered_s()
    return covered / total if total > 0 else 1.0


def chrome_trace(traces: Iterable[RequestTrace]) -> dict:
    """Convert traces to Chrome ``traceEvents`` JSON (open in
    ``chrome://tracing`` / Perfetto; one row per request)."""
    events: List[dict] = []
    for tr in traces:
        for s in tr.spans:
            events.append({
                "name": s.name,
                "cat": "serve",
                "ph": "X",
                "ts": s.start * 1e6,          # microseconds
                "dur": s.duration_s * 1e6,
                "pid": 0,
                "tid": tr.trace_id,
                "args": {
                    "rows": tr.rows,
                    "k": tr.k,
                    "bucket": tr.bucket,
                    "status": tr.status,
                    "retries": tr.retries,
                },
            })
        events.append({
            "name": "thread_name",
            "ph": "M",
            "pid": 0,
            "tid": tr.trace_id,
            "args": {"name": f"request {tr.trace_id} ({tr.rows} rows)"},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- roofline-drift monitor ---------------------------------------------------


class _BucketDrift:
    __slots__ = ("samples", "warmup_ratios", "baseline", "ewma")

    def __init__(self):
        self.samples = 0
        self.warmup_ratios: List[float] = []
        self.baseline: Optional[float] = None
        self.ewma: Optional[float] = None


class DriftMonitor:
    """Live roofline drift: measured dispatch wall vs Eq. 10/20 predicted.

    Per bucket, tracks the EWMA of ``measured_s / predicted_s`` and
    normalizes it by a baseline — the *median* of the first ``warmup``
    ratios.  The baseline calibrates out the constant model-vs-platform
    offset (the prediction is a bound from the profile's peaks, and a
    plain path on the CPU is orders of magnitude off it), so
    the reported ``drift`` is ~1.0 in steady state on any platform and
    moves only when the measured cost *changes relative to the model* —
    exactly the ``plan="measure"`` signal, continuously.  ``degraded``
    when any calibrated bucket's drift leaves ``band``.

    >>> mon = DriftMonitor(band=(0.5, 2.0), warmup=2, alpha=1.0)
    >>> for _ in range(2):
    ...     mon.record("64", measured_s=1e-3, predicted_s=1e-5)
    >>> mon.report()["in_band"]
    True
    >>> mon.record("64", measured_s=10e-3, predicted_s=1e-5)  # 10x slower
    >>> mon.report()["in_band"]
    False
    """

    def __init__(
        self,
        band: Tuple[float, float] = (0.25, 4.0),
        warmup: int = 3,
        alpha: float = 0.25,
    ):
        lo, hi = float(band[0]), float(band[1])
        if not 0.0 < lo < hi:
            raise ValueError(f"band must be 0 < lo < hi, got {band}")
        if warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {warmup}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.band = (lo, hi)
        self.warmup = int(warmup)
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._buckets: Dict[str, _BucketDrift] = {}

    def record(
        self, bucket, measured_s: float, predicted_s: float
    ) -> None:
        """Fold one dispatch's (measured, predicted) pair into the EWMA."""
        if measured_s <= 0 or predicted_s <= 0:
            return
        ratio = float(measured_s) / float(predicted_s)
        key = str(bucket)
        with self._lock:
            st = self._buckets.get(key)
            if st is None:
                st = self._buckets[key] = _BucketDrift()
            st.samples += 1
            st.ewma = (
                ratio if st.ewma is None
                else self.alpha * ratio + (1 - self.alpha) * st.ewma
            )
            if st.baseline is None:
                st.warmup_ratios.append(ratio)
                if len(st.warmup_ratios) >= self.warmup:
                    st.baseline = float(np.median(st.warmup_ratios))
                    st.warmup_ratios = []

    def report(self) -> dict:
        """Drift report: headline ``value`` (worst calibrated bucket's
        normalized ratio; 1.0 while still warming up), the ``band``,
        ``in_band``, and the per-bucket evidence."""
        lo, hi = self.band
        with self._lock:
            per_bucket = {}
            worst: Optional[float] = None
            for key, st in sorted(self._buckets.items()):
                drift = (
                    st.ewma / st.baseline
                    if st.baseline not in (None, 0.0) and st.ewma is not None
                    else None
                )
                per_bucket[key] = {
                    "samples": st.samples,
                    "ratio_ewma": st.ewma,
                    "baseline": st.baseline,
                    "drift": drift,
                    "in_band": drift is None or lo <= drift <= hi,
                }
                if drift is not None and (
                    worst is None
                    or abs(np.log(drift)) > abs(np.log(worst))
                ):
                    worst = drift
        value = 1.0 if worst is None else float(worst)
        return {
            "value": value,
            "band": [lo, hi],
            "in_band": lo <= value <= hi,
            "calibrated": worst is not None,
            "per_bucket": per_bucket,
        }

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()


# -- process-global registry --------------------------------------------------

_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global :class:`MetricsRegistry` every layer reports to."""
    return _REGISTRY


def export_prometheus() -> str:
    """Prometheus text export of the global registry (all series, the
    adopted legacy counter dicts included)."""
    return _REGISTRY.export_prometheus()


def export_json() -> dict:
    """JSON-serializable snapshot of the global registry."""
    return _REGISTRY.export_json()


def reset_all() -> None:
    """Zero every global series and every adopted counter dict
    (``DISPATCH_COUNTS``, ``PACK_EVENTS``, ``LAUNCHES``, ``PLAIN_CALLS``
    and ``SERVE_EVENTS`` register themselves at import)."""
    _REGISTRY.reset()
