"""Concurrent query serving: async micro-batching over one shared ``Index``.

Port of ``src/repro/search/serve.py``.  ``SearchServer`` accepts
per-request queries (each with its own ``k`` budget against the shared
index), coalesces them FIFO, whole requests only, into micro-batches
padded to a fixed ladder of bucket shapes, dispatches each batch as one
search and scatters per-request slices back.  The contracts are the
reference's: the bucket ladder (``plan.plan_buckets``), admission and
backpressure (``QueueFull``, ``Overloaded``), deadlines
(``DeadlineExceeded``: an expired ticket is never dispatched), retries
with backoff, the watchdog that restarts a dead worker without losing
tickets, load shedding, ``health()`` and ``stats()``, request traces and
the roofline-drift monitor (``repro_torch.search.telemetry``), the
served-query cluster-miss monitor (``cluster.query_miss_rate``), and the
deterministic ``VirtualClock`` mode (no threads; the caller drives
``step()``).

The GPU form, for an index on a CUDA device:

  * **One CUDA graph per bucket.**  The counterpart of a pre-compiled
    bucket is a captured graph of the index's search of a bucket-sized
    block (``Index.search_graph``, ``backends.GraphCache``), replayed with
    one host call.  ``precompile`` (``warmup=True``) makes one eager
    search per bucket (it loads the kernels' library and sets their
    shared-memory attributes) and captures the bucket's graph; otherwise
    a bucket is captured at its first use.  A capture that fails raises.
    A mutation that reallocates what a graph reads recaptures at the next
    batch.  An oversize request (more rows than ``max_batch``) is searched
    eagerly and never captured, as the reference never caches its shape.
    A clustered index is captured like any other: its pruned path holds
    no host sync.
  * **Staging.**  Each bucket owns two slots, each a pinned host buffer of
    queries in the compute dtype (numpy has no bf16) and pinned result
    buffers; a batch takes the slot the batch still in flight does not
    hold.  All device work runs on the server's stream, in order: the
    non-blocking copy of the slot into the graph's static input, the
    replay, one non-blocking copy of the values and indices into the
    slot's result buffers, then an event.  A replay can therefore never
    overwrite outputs that an earlier batch of the same bucket has not
    copied out.
  * **Results.**  ``_finalize`` waits on the batch's event, never on the
    whole device, and tickets receive CPU tensor slices of the batch's
    result (one transfer a batch).
  * **Mutations.**  ``mutation()`` takes the dispatch gate, makes the
    caller's stream wait for the server's stream (no replay in flight
    reads an operand the mutation patches or frees) and, on exit, the
    server's stream wait for the caller's (the next replay sees it).
  * **Counters.**  A replay does not pass through the kernels' front
    ends, so it does not move ``LAUNCHES``: the server counts each replay
    as one dispatch (``DISPATCH_COUNTS``) and as ``graph_replays``, and
    every other batch as ``eager_batches``; a graph's capture counts its
    kernels once (``SearchGraph.launches``).

On the CPU there are no graphs: every batch is an eager ``Index.search``
of the staged block.  On the card, a server over the ``"cuda"`` backend
takes batches of at least ``kernels.partial_reduce.BLOCK_M`` rows by
default (the kernels score any M in one launch, a block of 128 queries
at a time; ``query_block`` bounds only the plain paths' score tile), its
ladder extended to that size.

``SERVE_EVENTS`` counts batches, coalesced requests, padded rows,
oversize batches, graph replays and eager batches, and the failure
taxonomy ("deadline_expired", "transient_faults", "dispatch_retries",
"failed_batches", "worker_deaths", "worker_restarts",
"requeued_tickets", "load_shed", "miss_sampled_rows") across every
server; ``SearchServer.stats()`` has the per-server view, and
``docs/operations.md`` maps each counter to its operator action.

Typical use::

    from repro_torch.search import Index, SearchServer

    server = SearchServer(Index.build(db, k=10), warmup=True)
    ticket = server.submit(q, deadline_s=0.1)   # from any thread
    values, indices = ticket.result()  # (m_i, k) CPU slices of one batch
    server.close()
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import partial_reduce as kernels
from repro_torch.search import cluster as clusterlib
from repro_torch.search import faults as faultslib
from repro_torch.search import telemetry as telemetrylib
from repro_torch.search.index import Index, SearchResult
from repro_torch.search.plan import plan_buckets

__all__ = [
    "DeadlineExceeded",
    "Overloaded",
    "QueueFull",
    "SERVE_EVENTS",
    "SearchServer",
    "SearchTicket",
    "ServeConfig",
    "VirtualClock",
    "reset_serve_events",
]

# event name -> count across every server (the module docstring lists the
# names).
SERVE_EVENTS = telemetrylib.AtomicCounter()
telemetrylib.registry().register_counter_dict(
    "repro_serve_events_total", SERVE_EVENTS, "event",
    "SearchServer lifecycle and failure events (docs/operations.md)",
)


def reset_serve_events() -> None:
    """Zero ``SERVE_EVENTS`` (``telemetry.reset_all()`` zeroes it with
    every other series)."""
    SERVE_EVENTS.clear()


class QueueFull(RuntimeError):
    """Admission control rejected a request: the pending-row queue is full."""


class Overloaded(QueueFull):
    """Sustained-overload load shed: the queue has been full past
    ``ServeConfig.overload_grace_s``; ``retry_after_s`` is the server's
    estimate of when queued work will have drained."""

    def __init__(self, rows_pending: int, retry_after_s: float):
        self.rows_pending = rows_pending
        self.retry_after_s = retry_after_s
        super().__init__(
            f"server overloaded: {rows_pending} rows pending past the "
            f"overload grace window; retry in ~{retry_after_s:.3f}s"
        )


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before its batch was dispatched; its
    rows were never dispatched.  Raised through ``SearchTicket.result()``."""

    def __init__(self, rows: int, deadline: float, now: float):
        self.deadline = deadline
        super().__init__(
            f"deadline {deadline:.6f} passed (now {now:.6f}) before "
            f"dispatch; request of {rows} rows was never dispatched"
        )


class VirtualClock:
    """Deterministic, manually-advanced clock for tests and simulation.

    A server built with ``clock=VirtualClock()`` runs no threads and never
    sleeps; latency accounting reads this clock.

    >>> clock = VirtualClock()
    >>> clock.advance(0.5)
    0.5
    >>> clock.now()
    0.5
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance time backwards (dt={dt})")
        self._now += dt
        return self._now


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Frozen serving policy for one :class:`SearchServer` (the
    reference's fields and meanings).

    Attributes:
      max_batch: most query rows one micro-batch holds.  None defers to the
        spec's ``query_block`` (on the card's kernel path at least
        ``BLOCK_M``).
      buckets: ascending batch shapes; a coalesced batch pads up to the
        smallest bucket holding it.  None defers to
        ``SearchSpec.serve_buckets``, clipped to ``max_batch``.
      max_pending_rows: admission bound on queued (undispatched) rows.
      max_delay_s: wall-clock coalescing window.
      admission_timeout_s: longest a wall-clock ``submit`` blocks for
        queue space before raising :class:`QueueFull`.
      max_dispatch_retries: redispatch attempts after a retryable fault.
      retry_backoff_s: base backoff before the first retry, doubled per
        attempt (virtual-clock servers advance the clock instead).
      retryable: exception types the retry loop redispatches on.
      overload_grace_s: how long the queue must stay full before
        ``submit`` sheds load with :class:`Overloaded`.
      miss_sample_every: on clustered indexes, sample the served-query
        cluster-miss rate every Nth batch (0 disables the monitor).
      miss_sample_rows: query rows scored per sample.
      trace_buffer: completed request traces kept (0 disables tracing).
      drift_band: (lo, hi) band of the roofline-drift monitor's normalized
        measured/predicted ratio; outside it ``health()`` degrades.
      drift_warmup: dispatches per bucket that fix the drift baseline.
      drift_alpha: EWMA weight of the newest dispatch's ratio.
    """

    max_batch: Optional[int] = None
    buckets: Optional[Tuple[int, ...]] = None
    max_pending_rows: int = 4096
    max_delay_s: float = 0.002
    admission_timeout_s: float = 5.0
    max_dispatch_retries: int = 2
    retry_backoff_s: float = 0.001
    retryable: Tuple[type, ...] = (faultslib.TransientFault,)
    overload_grace_s: float = 0.25
    miss_sample_every: int = 32
    miss_sample_rows: int = 8
    trace_buffer: int = 256
    drift_band: Tuple[float, float] = (0.25, 4.0)
    drift_warmup: int = 3
    drift_alpha: float = 0.25

    def __post_init__(self):
        if self.max_batch is not None and self.max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got {self.max_batch}")
        if self.max_pending_rows <= 0:
            raise ValueError(
                f"max_pending_rows must be positive, got {self.max_pending_rows}"
            )
        if self.max_delay_s < 0 or self.admission_timeout_s < 0:
            raise ValueError("delays/timeouts must be non-negative")
        if self.max_dispatch_retries < 0:
            raise ValueError(
                f"max_dispatch_retries must be >= 0, got "
                f"{self.max_dispatch_retries}"
            )
        if self.retry_backoff_s < 0 or self.overload_grace_s < 0:
            raise ValueError("backoff/grace must be non-negative")
        if self.miss_sample_every < 0 or self.miss_sample_rows <= 0:
            raise ValueError(
                "miss_sample_every must be >= 0 and miss_sample_rows > 0"
            )
        if self.trace_buffer < 0:
            raise ValueError(
                f"trace_buffer must be >= 0, got {self.trace_buffer}"
            )
        lo, hi = self.drift_band
        if not 0.0 < lo < hi:
            raise ValueError(f"drift_band must be 0 < lo < hi, got "
                             f"{self.drift_band}")
        if self.drift_warmup < 1:
            raise ValueError(
                f"drift_warmup must be >= 1, got {self.drift_warmup}"
            )
        if not 0.0 < self.drift_alpha <= 1.0:
            raise ValueError(
                f"drift_alpha must be in (0, 1], got {self.drift_alpha}"
            )
        if self.buckets is not None:
            object.__setattr__(
                self, "buckets", tuple(int(b) for b in self.buckets)
            )


class _Slot:
    """One staging slot of a bucket: the query rows (pinned on the card),
    the result buffers a replay's outputs are copied into (allocated at
    the first replay) and the event that follows that copy."""

    __slots__ = ("queries", "values", "indices", "event")

    def __init__(self, rows: int, dim: int, dtype: torch.dtype, cuda: bool):
        self.queries = torch.zeros((rows, dim), dtype=dtype, pin_memory=cuda)
        self.values = self.indices = None
        self.event = torch.cuda.Event() if cuda else None


class _Pending:
    """A dispatched batch's result: ``wait()`` blocks on its event (if
    any) and returns CPU ``(values, indices)`` that no later batch
    overwrites."""

    __slots__ = ("values", "indices", "event", "slot")

    def __init__(self, values, indices, event=None, slot=None):
        self.values, self.indices = values, indices
        self.event, self.slot = event, slot

    def wait(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.event is not None:
            self.event.synchronize()
        if self.slot is not None:  # the slot's buffers serve later batches
            return self.values.clone(), self.indices.clone()
        return self.values.cpu(), self.indices.cpu()


class SearchTicket:
    """Handle for one submitted request; resolves to a ``SearchResult``.

    ``result()`` returns ``(values, indices)`` of shape ``(rows, k)``: the
    request's slice of its coalesced batch as CPU tensors (results cross
    to the host once a batch).
    """

    __slots__ = (
        "rows", "k", "deadline", "submitted_at", "completed_at", "trace",
        "_queries", "_offset", "_server", "_done", "_event", "_result",
        "_error",
    )

    def __init__(self, server: "SearchServer", queries: torch.Tensor, k: int,
                 deadline: Optional[float] = None):
        self._server = server
        self._queries = queries
        self.rows = queries.shape[0]
        self.k = k
        self.deadline = deadline  # absolute, on the server's clock
        self.submitted_at = server._now()
        self.completed_at: Optional[float] = None
        self.trace: Optional[telemetrylib.RequestTrace] = None
        self._offset = 0
        self._done = False
        # allocated (under the server lock) only when a thread blocks
        self._event: Optional[threading.Event] = None
        self._result: Optional[SearchResult] = None
        self._error: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        return self._done

    @property
    def latency_s(self) -> Optional[float]:
        """Submit-to-completion latency on the server's clock."""
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    def result(self, timeout: Optional[float] = None) -> SearchResult:
        """The request's ``(values (rows, k), indices (rows, k))``.

        Wall-clock servers block until the worker completes the request;
        virtual-clock servers drive their queue to idle first.
        """
        if not self._done and self._server._manual:
            self._server.run_until_idle()
        if not self._done:
            with self._server._lock:  # completion holds the same lock
                event = self._event
                if event is None and not self._done:
                    event = self._event = threading.Event()
            if event is not None and not event.wait(timeout):
                raise TimeoutError(
                    f"request ({self.rows} rows) still pending after "
                    f"{timeout}s"
                )
        if self._error is not None:
            raise self._error
        return self._result

    def _complete(self, result: SearchResult, now: float) -> None:
        """Caller must hold the server lock (see ``result``)."""
        self._result = result
        self.completed_at = now
        self._queries = None
        self._done = True
        if self.trace is not None:
            self.trace.status = "done"
            self.trace.completed_at = now
            self._server._store_trace(self.trace)
        if self._event is not None:
            self._event.set()

    def _fail(self, error: BaseException, now: float) -> None:
        """Caller must hold the server lock."""
        self._error = error
        self.completed_at = now
        self._queries = None
        self._done = True
        tr = self.trace
        if tr is not None:
            tr.status = "failed"
            tr.completed_at = now
            last = max((sp.end for sp in tr.spans), default=self.submitted_at)
            tr.span("failed", last, now)
            self._server._store_trace(tr)
        if self._event is not None:
            self._event.set()


class SearchServer:
    """Async micro-batching front end over one shared :class:`Index`.

    ``clock=None`` (default) starts a background worker thread that
    coalesces on the wall clock; a :class:`VirtualClock` selects the
    deterministic single-threaded mode driven by ``step()`` /
    ``run_until_idle()``.  ``warmup=True`` captures every bucket's graph
    (on the CPU: searches each bucket once) before the first request.
    """

    def __init__(
        self,
        index: Index,
        config: Optional[ServeConfig] = None,
        *,
        clock: Optional[VirtualClock] = None,
        warmup: bool = False,
        faults: Optional[faultslib.FaultInjector] = None,
    ):
        self.index = index
        # per-server injector for the serve.* points; None falls through
        # to the process-global ``faults.active()``
        self._faults = faults
        self.config = config or ServeConfig()
        spec = index.spec
        if not spec.aggregate_to_topk:
            raise ValueError(
                "SearchServer requires aggregate_to_topk=True: per-request "
                "k budgets are column slices of the coalesced dispatch, "
                "which is only correct over sorted top-k rows — not the "
                "raw unsorted bin winners"
            )
        self._cuda = index.device.type == "cuda"
        qb = spec.query_block or 4096
        widened = (self._cuda and index._resolve_backend() == "cuda"
                   and qb < kernels.BLOCK_M)
        if widened:
            qb = kernels.BLOCK_M
        self.max_batch = self.config.max_batch or qb
        ladder = tuple(self.config.buckets or spec.serve_buckets
                       or plan_buckets(self.max_batch))
        if widened and self.config.buckets is None:
            ladder += plan_buckets(self.max_batch)
        buckets = sorted({int(b) for b in ladder if b <= self.max_batch})
        if not buckets or buckets[-1] != self.max_batch:
            buckets.append(self.max_batch)
        self.buckets: Tuple[int, ...] = tuple(buckets)
        self._qdtype = index.query_dtype
        # all of this server's device work runs on its own stream, in order
        self._stream = torch.cuda.Stream(index.device) if self._cuda else None

        self._clock = clock
        self._manual = clock is not None
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._pending_rows = 0
        self._closed = False
        # (pending, batch, bucket, t_disp0): dispatched, not yet scattered
        self._inflight: Optional[tuple] = None
        # serializes dispatches against out-of-band Index mutations
        self._dispatch_gate = threading.Lock()
        self._staging: Dict[int, list] = {}
        self._stats = telemetrylib.AtomicCounter()
        self._latency_sum = 0.0
        self._worker: Optional[threading.Thread] = None
        self._full_since: Optional[float] = None
        self._service_ema = 0.0
        self._miss_sample_countdown = self.config.miss_sample_every
        self._started_at = self._now()
        self._traces: Optional[collections.deque] = (
            collections.deque(maxlen=self.config.trace_buffer)
            if self.config.trace_buffer > 0 else None
        )
        self._trace_seq = 0
        self._drift = telemetrylib.DriftMonitor(
            band=self.config.drift_band,
            warmup=self.config.drift_warmup,
            alpha=self.config.drift_alpha,
        )
        self._predicted_cache: Dict[int, Optional[float]] = {}
        self._last_fault: Optional[dict] = None
        # seconds of each bucket's warm-up and capture (precompile)
        self.capture_s: Dict[int, float] = {}

        if warmup:
            self.precompile()
        if not self._manual:
            self._worker = threading.Thread(
                target=self._worker_main, name="SearchServer", daemon=True
            )
            self._worker.start()

    # -- time / fault plumbing -----------------------------------------------

    def _now(self) -> float:
        return self._clock.now() if self._manual else time.monotonic()

    def _fire(self, point: str) -> None:
        """Hit a serve.* injection point (per-server injector first, then
        the process-global one)."""
        inj = self._faults if self._faults is not None else faultslib.active()
        if inj is not None:
            inj.fire(point)

    def _backoff(self, delay: float) -> None:
        """Retry backoff: sleep on the wall clock, advance a virtual one."""
        if delay <= 0:
            return
        if self._manual:
            self._clock.advance(delay)
        else:
            time.sleep(delay)

    # -- admission -----------------------------------------------------------

    @property
    def pending_rows(self) -> int:
        """Query rows admitted but not yet dispatched."""
        return self._pending_rows

    def submit(self, queries, k: Optional[int] = None,
               deadline_s: Optional[float] = None) -> SearchTicket:
        """Enqueue one request: ``(rows, D)`` (or a single ``(D,)`` row).

        ``k`` is the request's own budget, at most the index's
        ``spec.k``; ``deadline_s`` is relative, on the server's clock.
        Raises :class:`QueueFull` when admission control rejects the
        request, or :class:`Overloaded` under sustained overload.
        """
        q = torch.as_tensor(queries, dtype=torch.float32, device="cpu")
        q = q.to(self._qdtype)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[0] == 0:
            raise ValueError(f"queries must be (rows>0, D), got {tuple(q.shape)}")
        if q.shape[1] != self.index.dim:
            raise ValueError(
                f"query dim {q.shape[1]} != index dim {self.index.dim}"
            )
        k = self.index.spec.k if k is None else int(k)
        if not 0 < k <= self.index.spec.k:
            raise ValueError(
                f"per-request k={k} must be in [1, spec.k={self.index.spec.k}]"
                " — build the index with the largest k any request needs"
            )
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        rows = q.shape[0]
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            if rows > self.config.max_pending_rows:
                raise QueueFull(
                    f"request of {rows} rows exceeds the admission capacity "
                    f"({self.config.max_pending_rows} rows)"
                )
            if self._pending_rows + rows > self.config.max_pending_rows:
                now = self._now()
                if self._full_since is None:
                    self._full_since = now
                if now - self._full_since >= self.config.overload_grace_s:
                    self._shed_locked()  # raises Overloaded
                if self._manual:
                    raise QueueFull(
                        f"{self._pending_rows} rows pending; admitting {rows} "
                        f"more exceeds max_pending_rows="
                        f"{self.config.max_pending_rows}"
                    )
                timeout = time.monotonic() + self.config.admission_timeout_s
                while self._pending_rows + rows > self.config.max_pending_rows:
                    remaining = timeout - time.monotonic()
                    if remaining <= 0 or self._closed:
                        raise QueueFull(
                            f"no queue space for {rows} rows within "
                            f"{self.config.admission_timeout_s}s"
                        )
                    self._not_full.wait(remaining)
                    if (
                        self._pending_rows + rows
                        > self.config.max_pending_rows
                        and self._full_since is not None
                        and self._now() - self._full_since
                        >= self.config.overload_grace_s
                    ):
                        # full past the grace window while this thread
                        # waited: fail fast with the structured signal
                        self._shed_locked()
                if self._closed:
                    # close() may have drained the queue while we waited
                    raise RuntimeError("server is closed")
            deadline = (
                None if deadline_s is None else self._now() + deadline_s
            )
            ticket = SearchTicket(self, q, k, deadline)
            if self._traces is not None:
                self._trace_seq += 1
                tr = telemetrylib.RequestTrace(
                    self._trace_seq, rows, k, ticket.submitted_at
                )
                tr.span("submit", ticket.submitted_at, ticket.submitted_at)
                ticket.trace = tr
            self._queue.append(ticket)
            self._pending_rows += rows
            self._stats["peak_pending_rows"] = max(
                self._stats["peak_pending_rows"], self._pending_rows
            )
            telemetrylib.registry().set_gauge(
                "repro_serve_pending_rows", self._pending_rows
            )
            self._work.notify()
        return ticket

    def search(self, queries, k: Optional[int] = None,
               timeout: Optional[float] = None) -> SearchResult:
        """Synchronous convenience: ``submit`` + ``result`` in one call."""
        return self.submit(queries, k=k).result(timeout=timeout)

    def resolve(self, tickets: Sequence[SearchTicket],
                timeout: Optional[float] = None) -> List[SearchResult]:
        """Resolve many tickets (driving the queue first in virtual mode)."""
        if self._manual:
            self.run_until_idle()
        return [t.result(timeout=timeout) for t in tickets]

    # -- micro-batch formation and dispatch ----------------------------------

    def _shed_locked(self) -> None:
        """Raise :class:`Overloaded` with a drain-time estimate (caller
        must hold the lock)."""
        batches = max(1, -(-self._pending_rows // self.max_batch))
        per_batch = max(
            self._service_ema, self.config.max_delay_s, 1e-3
        )
        self._stats.inc("load_shed")
        SERVE_EVENTS.inc("load_shed")
        raise Overloaded(self._pending_rows, batches * per_batch)

    def _fail_expired_locked(self, t: SearchTicket, now: float) -> None:
        """Fail one deadline-expired ticket (caller must hold the lock)."""
        t._fail(DeadlineExceeded(t.rows, t.deadline, now), now)
        self._stats.inc("deadline_expired")
        SERVE_EVENTS.inc("deadline_expired")

    def _take_batch_locked(self, now: float) -> Optional[List[SearchTicket]]:
        """Pop the next FIFO micro-batch: whole requests only, up to
        ``max_batch`` rows (a larger request ships solo).  Expired tickets
        are failed here, never staged or dispatched."""
        batch: List[SearchTicket] = []
        total = 0
        while self._queue:
            head = self._queue[0]
            if head.deadline is not None and now >= head.deadline:
                self._queue.popleft()
                self._pending_rows -= head.rows
                self._fail_expired_locked(head, now)
                continue
            if batch and total + head.rows > self.max_batch:
                break
            self._queue.popleft()
            batch.append(head)
            total += head.rows
            if total >= self.max_batch:
                break
        self._pending_rows -= total
        if self._pending_rows < self.config.max_pending_rows:
            self._full_since = None
        telemetrylib.registry().set_gauge(
            "repro_serve_pending_rows", self._pending_rows
        )
        return batch or None

    def _expire_batch(
        self, batch: List[SearchTicket], now: float
    ) -> List[SearchTicket]:
        """Drop (and fail) tickets whose deadline passed — re-checked
        before every retry."""
        live = [
            t for t in batch if t.deadline is None or now < t.deadline
        ]
        if len(live) != len(batch):
            with self._lock:
                for t in batch:
                    if t.deadline is not None and now >= t.deadline:
                        self._fail_expired_locked(t, now)
        return live

    def _record_fault(self, error: BaseException) -> None:
        self._last_fault = {
            "error": type(error).__name__,
            "point": getattr(error, "point", None),
            "detail": str(error),
            "at": self._now(),
        }

    def _fail_batch(self, batch: List[SearchTicket],
                    error: BaseException) -> None:
        """Fail every ticket of a batch with one typed error."""
        self._record_fault(error)
        now = self._now()
        with self._lock:
            for t in batch:
                t._fail(error, now)
        self._stats.inc("failed_batches")
        SERVE_EVENTS.inc("failed_batches")

    def _requeue(self, batch: List[SearchTicket]) -> None:
        """Put a popped-but-undispatched batch back at the queue front."""
        with self._lock:
            for t in reversed(batch):
                self._queue.appendleft(t)
                self._pending_rows += t.rows
        self._stats.inc("requeued_tickets", len(batch))
        SERVE_EVENTS.inc("requeued_tickets", len(batch))

    def _bucket_for(self, rows: int) -> int:
        """Smallest bucket holding ``rows``; oversize requests double up
        from ``max_batch``."""
        if rows <= self.max_batch:
            return self.buckets[bisect.bisect_left(self.buckets, rows)]
        bucket = self.max_batch
        while bucket < rows:
            bucket *= 2
        self._stats.inc("oversize_batches")
        SERVE_EVENTS.inc("oversize_batches")
        return bucket

    def _stage(self, bucket: int, batch: List[SearchTicket]) -> _Slot:
        """Gather the batch's query rows into a staging slot.

        Two slots per bucket; a batch takes the one the batch in flight
        does not hold, so its rows and results are never overwritten
        before it is scattered.  Oversize batches get a transient slot,
        never cached."""
        if bucket > self.max_batch:
            slot = _Slot(bucket, self.index.dim, self._qdtype, False)
        else:
            pair = self._staging.get(bucket)
            if pair is None:
                pair = self._staging[bucket] = [
                    _Slot(bucket, self.index.dim, self._qdtype, self._cuda),
                    _Slot(bucket, self.index.dim, self._qdtype, self._cuda),
                ]
            held = self._inflight[0].slot if self._inflight else None
            slot = pair[1] if pair[0] is held else pair[0]
            self._stats.inc("staging_swaps")
        offset = 0
        buf = slot.queries
        for t in batch:
            buf[offset : offset + t.rows] = t._queries
            t._offset = offset
            offset += t.rows
        buf[offset:] = 0.0  # bucket padding: dead rows, sliced away at scatter
        return slot

    def _dispatch(self, bucket: int, slot: _Slot) -> _Pending:
        """One search of the staged block: a graph replay on the card for
        a regular bucket, else an eager ``Index.search``."""
        if not self._cuda:
            self._count("eager_batches")
            return _Pending(*self.index.search(slot.queries))
        with torch.cuda.stream(self._stream):
            if bucket > self.max_batch:
                self._count("eager_batches")
                res = self.index.search(slot.queries.to(self.index.device))
                event = torch.cuda.Event()
                event.record()
                return _Pending(res.values, res.indices, event)
            graph = self.index.search_graph(bucket)
            graph.queries.copy_(slot.queries, non_blocking=True)
            self.index.replay_graph(graph)
            if slot.values is None:
                slot.values = torch.empty(graph.values.shape,
                                          dtype=graph.values.dtype,
                                          pin_memory=True)
                slot.indices = torch.empty(graph.indices.shape,
                                           dtype=graph.indices.dtype,
                                           pin_memory=True)
            slot.values.copy_(graph.values, non_blocking=True)
            slot.indices.copy_(graph.indices, non_blocking=True)
            slot.event.record()
            self._count("graph_replays")
            return _Pending(slot.values, slot.indices, slot.event, slot)

    def _count(self, event: str, n: int = 1) -> None:
        self._stats.inc(event, n)
        SERVE_EVENTS.inc(event, n)

    def _service_once(self) -> bool:
        """Dispatch ONE coalesced micro-batch; then scatter the previous.

        Stage and enqueue the new batch first, then wait on the previous
        one's result and scatter it, so host work overlaps device work.
        Retryable faults redispatch after exponential backoff, re-checking
        deadlines; exhausted retries and other errors fail the batch's
        tickets with the typed error; :class:`WorkerDeath` requeues the
        batch (nothing was dispatched) and propagates to the watchdog.
        """
        self._fire("serve.worker")  # death here: nothing popped yet
        cfg = self.config
        t_start = time.perf_counter()
        with self._lock:
            batch = self._take_batch_locked(self._now())
            if batch is not None:
                self._not_full.notify_all()
        if batch is None:
            self._finalize(self._pop_inflight())
            return False
        t_pop = self._now()
        attempt = 0
        while True:
            try:
                # inside the guard: a failing allocation fails the batch's
                # tickets instead of killing the worker
                self._fire("serve.staging_alloc")
                t_coalesced = self._now()
                rows = sum(t.rows for t in batch)
                bucket = self._bucket_for(rows)
                slot = self._stage(bucket, batch)
                self._fire("serve.transfer")
                t_staged = self._now()
                # perf_counter BEFORE the injection point: an injected
                # delay lands inside the drift monitor's measured window
                t_disp0 = time.perf_counter()
                # fired OUTSIDE the gate: a death here while another thread
                # holds ``mutation()`` must not deadlock the restart
                self._fire("serve.dispatch")
                with self._dispatch_gate:
                    with self._profile_span(f"serve.dispatch[{bucket}]"):
                        pending = self._dispatch(bucket, slot)  # ONE dispatch
                break
            except faultslib.WorkerDeath:
                self._requeue(batch)
                raise
            except cfg.retryable as e:
                self._stats.inc("transient_faults")
                SERVE_EVENTS.inc("transient_faults")
                self._record_fault(e)
                if attempt >= cfg.max_dispatch_retries:
                    self._fail_batch(batch, e)
                    return True
                attempt += 1
                self._stats.inc("dispatch_retries")
                SERVE_EVENTS.inc("dispatch_retries")
                self._backoff(cfg.retry_backoff_s * (2 ** (attempt - 1)))
                batch = self._expire_batch(batch, self._now())
                if not batch:
                    return True
            except Exception as e:  # scatter the failure, keep serving
                self._fail_batch(batch, e)
                return True
        t_dispatched = self._now()
        for t in batch:
            tr = t.trace
            if tr is not None:
                # contiguous spans on the server clock; "scatter" closes
                # at completion
                tr.bucket = bucket
                tr.retries = attempt
                tr.span("queue", t.submitted_at, t_pop)
                tr.span("coalesce", t_pop, t_coalesced)
                tr.span("stage", t_coalesced, t_staged)
                tr.span("dispatch", t_staged, t_dispatched)
                tr.dispatched_at = t_dispatched
        self._stats.inc("batches")
        self._stats.inc("coalesced_requests", len(batch))
        self._stats.inc("dispatched_rows", rows)
        self._stats.inc("padded_rows", bucket - rows)
        SERVE_EVENTS.inc("batches")
        SERVE_EVENTS.inc("coalesced_requests", len(batch))
        SERVE_EVENTS.inc("padded_rows", bucket - rows)
        reg = telemetrylib.registry()
        reg.observe("repro_serve_batch_rows", rows, bucket=bucket)
        live = self._stats["dispatched_rows"] + self._stats["padded_rows"]
        if live:
            reg.set_gauge(
                "repro_serve_occupancy", self._stats["dispatched_rows"] / live
            )
        prev = self._pop_inflight()
        self._inflight = (pending, batch, bucket, t_disp0)
        self._finalize(prev)
        self._maybe_sample_miss(slot.queries, rows)
        elapsed = time.perf_counter() - t_start
        self._service_ema = (
            elapsed if self._service_ema == 0.0
            else 0.8 * self._service_ema + 0.2 * elapsed
        )
        return True

    def _pop_inflight(self) -> Optional[tuple]:
        entry, self._inflight = self._inflight, None
        return entry

    def _finalize(self, entry: Optional[tuple]) -> None:
        """Wait on a dispatched batch's result (its event, not the device)
        and scatter per-request CPU slices."""
        if entry is None:
            return
        pending, batch, bucket, t_disp0 = entry
        try:
            self._fire("serve.scatter")
            values, indices = pending.wait()
            # dispatch-to-ready wall: the measured side of the drift ratio
            measured_s = time.perf_counter() - t_disp0
        except faultslib.WorkerDeath as e:
            # the dispatch ran; fail its tickets, never re-dispatch it
            self._fail_batch(batch, e)
            raise
        except Exception as e:
            # device errors surface here: fail the batch, keep serving
            self._fail_batch(batch, e)
            return
        now = self._now()
        latencies = []
        with self._lock:  # one acquisition per batch
            for t in batch:
                tr = t.trace
                if tr is not None and tr.dispatched_at is not None:
                    tr.span("scatter", tr.dispatched_at, now)
                t._complete(
                    SearchResult(
                        values[t._offset : t._offset + t.rows, : t.k],
                        indices[t._offset : t._offset + t.rows, : t.k],
                    ),
                    now,
                )
                if t.latency_s is not None:
                    self._latency_sum += t.latency_s
                    latencies.append(t.latency_s)
            self._stats.inc("completed_requests", len(batch))
        reg = telemetrylib.registry()
        for lat in latencies:
            reg.observe("repro_serve_request_latency_seconds", lat)
        reg.observe(
            "repro_serve_dispatch_wall_seconds", measured_s,
            bucket=bucket,
        )
        self._record_drift(bucket, measured_s)

    def _maybe_sample_miss(self, queries: torch.Tensor, live_rows: int) -> None:
        """Served-query cluster-miss monitor: every Nth batch, score a few
        real query rows (the live front of the staged block) through
        ``cluster.query_miss_rate``.  Best effort: a failure leaves the
        signal stale and never takes serving down."""
        if self.config.miss_sample_every <= 0:
            return
        pk = self.index._packed
        cs = pk.cluster if pk is not None else None
        if cs is None:
            return
        self._miss_sample_countdown -= 1
        if self._miss_sample_countdown > 0:
            return
        self._miss_sample_countdown = self.config.miss_sample_every
        m = min(self.config.miss_sample_rows, live_rows)
        try:
            with self._dispatch_gate:
                rows, bias = pk.exact_rows_bias()
                missed, checked = clusterlib.query_miss_rate(
                    cs, queries[:m].to(self.index.device), rows, bias,
                    self.index.spec.k,
                )
        except Exception:
            return
        cs.served_miss_checked += checked
        cs.served_miss_missed += missed
        rate = cs.served_miss_rate
        if rate is not None:
            telemetrylib.registry().set_gauge(
                "repro_serve_cluster_miss_rate", rate
            )
        self._stats.inc("miss_sampled_rows", m)
        SERVE_EVENTS.inc("miss_sampled_rows", m)

    # -- deterministic (virtual-clock) driving -------------------------------

    def step(self) -> bool:
        """Virtual-clock driver: dispatch one micro-batch (scattering the
        previous one).  False, after finalizing any leftover batch, once
        the queue is empty."""
        if not self._manual:
            raise RuntimeError(
                "step() is the virtual-clock driver; wall-clock servers "
                "run their own worker thread"
            )
        try:
            return self._service_once()
        except faultslib.WorkerDeath:
            # the "worker" (this step) died and restarts at once; the
            # dying pass requeued its batch
            self._record_restart()
            return True

    def run_until_idle(self) -> None:
        """Drive the queue to empty and scatter everything in flight."""
        while self.step():
            pass

    # -- wall-clock worker ---------------------------------------------------

    def _record_restart(self) -> None:
        self._stats.inc("worker_deaths")
        self._stats.inc("worker_restarts")
        SERVE_EVENTS.inc("worker_deaths")
        SERVE_EVENTS.inc("worker_restarts")
        self._last_fault = {
            "error": "WorkerDeath",
            "point": "serve.worker",
            "detail": "worker died and was restarted by the watchdog",
            "at": self._now(),
        }

    def _worker_main(self) -> None:
        """Watchdog: restart a dead worker loop in the same thread (so
        ``close()``'s join works), without losing queued tickets."""
        while True:
            try:
                self._worker_loop()
                return
            except BaseException:
                with self._lock:
                    done = (
                        self._closed
                        and not self._queue
                        and self._inflight is None
                    )
                self._record_restart()
                if done:
                    return

    def _worker_loop(self) -> None:
        cfg = self.config
        while True:
            with self._lock:
                if self._closed and not self._queue:
                    break
                if not self._queue:
                    # idle: scatter any in-flight batch, then sleep on work
                    if self._inflight is None:
                        self._work.wait(0.05)
                else:
                    # coalescing window: hold the batch open until it fills
                    # or the head request's window expires
                    deadline = (
                        self._queue[0].submitted_at + cfg.max_delay_s
                    )
                    while (
                        self._queue
                        and self._pending_rows < self.max_batch
                        and not self._closed
                    ):
                        remaining = deadline - self._now()
                        if remaining <= 0:
                            break
                        self._work.wait(remaining)
            self._service_once()
        self._finalize(self._pop_inflight())

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting requests, drain the queue, join the worker."""
        with self._lock:
            self._closed = True
            self._work.notify_all()
            self._not_full.notify_all()
        if self._worker is not None:
            self._worker.join(timeout)
            self._worker = None
        elif self._manual:
            self.run_until_idle()

    def __enter__(self) -> "SearchServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- out-of-band index mutations -----------------------------------------

    @contextlib.contextmanager
    def mutation(self):
        """Serialize an ``Index`` mutation against the server's dispatches::

            with server.mutation():
                server.index.add(rows)

        ``Index`` is not thread-safe, and on the card an in-place add or
        delete is itself a kernel on the calling thread's stream: inside
        the block that stream waits for every replay the server has
        enqueued, and after it the server's stream waits for the mutation.
        A mutation that reallocates what a graph reads makes the next
        batch recapture.  No-op ordering on the CPU and under a virtual
        clock (single-threaded), but still safe to use.
        """
        with self._dispatch_gate:
            if self._cuda:
                torch.cuda.current_stream(self.index.device).wait_stream(
                    self._stream)
            try:
                yield
            finally:
                if self._cuda:
                    self._stream.wait_stream(
                        torch.cuda.current_stream(self.index.device))

    # -- observability -------------------------------------------------------

    def _profile_span(self, name: str):
        """``torch.profiler.record_function`` around the dispatch (a range
        in a profiler trace)."""
        return torch.profiler.record_function(name)

    def _store_trace(self, trace: telemetrylib.RequestTrace) -> None:
        """Push a completed trace into the bounded ring buffer (callers
        hold the server lock)."""
        if self._traces is not None:
            self._traces.append(trace)

    def traces(self, n: Optional[int] = None) -> List[telemetrylib.RequestTrace]:
        """The most recent completed request traces, oldest first."""
        if self._traces is None:
            return []
        with self._lock:
            out = list(self._traces)
        return out if n is None else out[-int(n):]

    def drift(self) -> dict:
        """The roofline-drift monitor's report (``health()["drift"]``)."""
        return self._drift.report()

    def _predicted_s(self, bucket: int) -> Optional[float]:
        """The plan's predicted seconds for one ``bucket``-row search
        (``Index._replan`` at that batch, the build's cluster decision
        kept), memoized; None when the planner cannot price it."""
        if bucket in self._predicted_cache:
            return self._predicted_cache[bucket]
        try:
            plan = self.index.kernel_plan
            if plan.m == bucket:
                pred = plan.predicted_s
            else:
                pred = self.index._replan(
                    n=plan.n, m=bucket, pin_from=plan).predicted_s
            pred = float(pred) if pred and pred > 0 else None
        except Exception:
            pred = None
        self._predicted_cache[bucket] = pred
        return pred

    def _record_drift(self, bucket: int, measured_s: float) -> None:
        predicted = self._predicted_s(bucket)
        if predicted is None or measured_s <= 0:
            return
        self._drift.record(str(bucket), measured_s, predicted)
        telemetrylib.registry().set_gauge(
            "repro_serve_drift", self._drift.report()["value"]
        )

    def precompile(self) -> int:
        """Make every bucket ready ahead of traffic: on the card, one
        eager search and the capture of its graph; on the CPU, one search.
        Returns the number of buckets warmed; ``capture_s`` holds each
        bucket's seconds."""
        for bucket in self.buckets:
            t0 = time.perf_counter()
            with self._dispatch_gate:  # may be called on a live server
                if self._cuda:
                    with torch.cuda.stream(self._stream):
                        self.index.search_graph(bucket)
                    self._stream.synchronize()
                else:
                    self.index.search(
                        torch.zeros((bucket, self.index.dim), dtype=self._qdtype))
            self.capture_s[bucket] = time.perf_counter() - t0
        self._stats["precompiled_buckets"] = len(self.buckets)
        return len(self.buckets)

    def stats(self) -> dict:
        """Serving counters: batching efficiency, queue pressure, graphs."""
        s = dict(self._stats)
        out = {
            "buckets": self.buckets,
            "max_batch": self.max_batch,
            "batches": s.get("batches", 0),
            "coalesced_requests": s.get("coalesced_requests", 0),
            "completed_requests": s.get("completed_requests", 0),
            "dispatched_rows": s.get("dispatched_rows", 0),
            "padded_rows": s.get("padded_rows", 0),
            "oversize_batches": s.get("oversize_batches", 0),
            "graph_replays": s.get("graph_replays", 0),
            "eager_batches": s.get("eager_batches", 0),
            "failed_batches": s.get("failed_batches", 0),
            "staging_swaps": s.get("staging_swaps", 0),
            "peak_pending_rows": s.get("peak_pending_rows", 0),
            "precompiled_buckets": s.get("precompiled_buckets", 0),
            "deadline_expired": s.get("deadline_expired", 0),
            "transient_faults": s.get("transient_faults", 0),
            "dispatch_retries": s.get("dispatch_retries", 0),
            "worker_deaths": s.get("worker_deaths", 0),
            "worker_restarts": s.get("worker_restarts", 0),
            "requeued_tickets": s.get("requeued_tickets", 0),
            "load_shed": s.get("load_shed", 0),
            "miss_sampled_rows": s.get("miss_sampled_rows", 0),
            "pending_rows": self._pending_rows,
            "uptime_s": self._now() - self._started_at,
            "traced_requests": len(self._traces) if self._traces else 0,
            "cache": self.index.cache_info(),
        }
        live = out["dispatched_rows"] + out["padded_rows"]
        out["occupancy"] = out["dispatched_rows"] / live if live else 0.0
        done = out["completed_requests"]
        out["mean_latency_s"] = self._latency_sum / done if done else 0.0
        return out

    def health(self) -> dict:
        """Liveness / degradation report for operators and load balancers.

        ``status`` is ``"ok"``, ``"degraded"`` (a dead worker on an open
        server, the served-query cluster-miss estimate past its warn
        level, or the drift monitor out of its band) or ``"overloaded"``
        (the queue full past ``overload_grace_s``); the rest is the
        evidence (``docs/operations.md``).
        """
        with self._lock:
            pending = self._pending_rows
            queued = len(self._queue)
            full_since = self._full_since
            closed = self._closed
        now = self._now()
        worker_alive = self._manual or (
            self._worker is not None and self._worker.is_alive()
        )
        overloaded = (
            full_since is not None
            and now - full_since >= self.config.overload_grace_s
        )
        s = self._stats
        report = {
            "worker_alive": worker_alive,
            "closed": closed,
            "uptime_s": now - self._started_at,
            "last_fault": self._last_fault,
            "pending_rows": pending,
            "queued_requests": queued,
            "deadline_expired": s.get("deadline_expired", 0),
            "transient_faults": s.get("transient_faults", 0),
            "dispatch_retries": s.get("dispatch_retries", 0),
            "failed_batches": s.get("failed_batches", 0),
            "worker_deaths": s.get("worker_deaths", 0),
            "worker_restarts": s.get("worker_restarts", 0),
            "load_shed": s.get("load_shed", 0),
            "requeued_tickets": s.get("requeued_tickets", 0),
        }
        miss_warning = False
        pk = self.index._packed
        cs = pk.cluster if pk is not None else None
        if cs is not None:
            report["cluster_miss"] = cs.served_miss_report()
            miss_warning = report["cluster_miss"]["warning"]
        drift = self._drift.report()
        report["drift"] = drift
        drift_warning = drift["calibrated"] and not drift["in_band"]
        try:
            recall_live = float(self.index.expected_recall_live)
        except Exception:
            recall_live = None
        report["expected_recall_live"] = recall_live
        reg = telemetrylib.registry()
        reg.set_gauge("repro_serve_uptime_seconds", report["uptime_s"])
        if recall_live is not None:
            reg.set_gauge("repro_serve_expected_recall_live", recall_live)
        degraded = (
            (not worker_alive and not closed) or miss_warning or drift_warning
        )
        report["status"] = (
            "overloaded" if overloaded
            else ("degraded" if degraded else "ok")
        )
        return report
