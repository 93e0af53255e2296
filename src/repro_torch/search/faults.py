"""Deterministic fault injection for the serving and index-mutation paths.

Port of ``src/repro/search/faults.py`` (the framework plays no part in
it): named injection points threaded through the hot paths, a seeded
registry that decides which hits fire, and a typed exception taxonomy
that the recovery code (retries, watchdog, load shedding) keys on.
Chaos runs driven from the ``VirtualClock`` serve mode are reproducible:
the same seed and schedule give the same failures, and an injector
fires at the same hits in both packages (each point's numpy generator is
seeded from ``(seed, crc32(point))``, as the reference seeds it).

Injection points (``INJECTION_POINTS``)
---------------------------------------

  ==================== ====================================================
  ``serve.worker``     start of each ``SearchServer`` service cycle (a
                       ``WorkerDeath`` here kills the worker *between*
                       batches — queue intact)
  ``serve.staging_alloc`` bucket selection + pinned staging gather
  ``serve.transfer``   just before the host->device query copy
  ``serve.dispatch``   just before the coalesced dispatch (a graph replay
                       or an eager ``Index`` search; the retry loop's
                       point: ``TransientFault`` here is retried)
  ``serve.scatter``    before waiting on the batch's result copy and
                       scattering per-request slices
  ``index.add``        entry of ``Index.add``
  ``index.delete``     entry of ``Index.delete``
  ``index.save``       entry of ``Index.save`` (before any file is written)
  ``checkpoint.commit`` inside the snapshot writer, after the tmp dir is
                       fully written but *before* the atomic rename (a
                       fault here leaves the committed snapshot untouched)
  ==================== ====================================================

Exception taxonomy
------------------

  * :class:`InjectedFault`  — common base (a ``RuntimeError``).
  * :class:`TransientFault` — retryable: the serve retry loop backs off and
    redispatches (bounded by ``ServeConfig.max_dispatch_retries``).
  * :class:`FatalFault`     — non-retryable: fails the affected tickets /
    operation with a typed error; the server keeps serving.
  * :class:`WorkerDeath`    — simulates the worker thread dying; the
    watchdog (and the virtual-clock ``step()``) restarts the worker
    without dropping queued tickets.
  * :class:`DelayFault`     — a slowdown, not an error: a hit of kind
    ``"delay"`` sleeps ``FaultInjector.delay_s`` and returns (the way to
    drive the roofline-drift monitor out of band); never raised.

Usage::

    from repro_torch.search import faults

    inj = faults.FaultInjector(
        seed=7,
        rates={"serve.dispatch": 0.05},             # 5% of dispatches
        schedule=[("serve.worker", 3, "death")],    # 3rd cycle exactly
    )
    faults.install(inj)          # process-global, or SearchServer(faults=inj)
    try:
        ...                      # drive traffic; faults fire deterministically
    finally:
        faults.uninstall()

Hit counters (``hits``) advance only when the instrumented code path
executes; with no injector installed every ``fire()`` is a no-op.  This
module is a leaf: nothing here imports the rest of the package.
"""
from __future__ import annotations

import contextlib
import threading
import time
import zlib
from collections import Counter
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "DelayFault",
    "FatalFault",
    "FaultInjector",
    "INJECTION_POINTS",
    "InjectedFault",
    "TransientFault",
    "WorkerDeath",
    "active",
    "fire",
    "injected",
    "install",
    "uninstall",
]

INJECTION_POINTS: Tuple[str, ...] = (
    "serve.worker",
    "serve.staging_alloc",
    "serve.transfer",
    "serve.dispatch",
    "serve.scatter",
    "index.add",
    "index.delete",
    "index.save",
    "checkpoint.commit",
)


class InjectedFault(RuntimeError):
    """Base of every injected failure (``point`` names where it fired)."""

    def __init__(self, point: str, hit: int, detail: str = ""):
        self.point = point
        self.hit = hit
        super().__init__(
            f"injected fault at {point!r} (hit #{hit})"
            + (f": {detail}" if detail else "")
        )


class TransientFault(InjectedFault):
    """Retryable failure (e.g. a transient runtime/transfer error)."""


class FatalFault(InjectedFault):
    """Non-retryable failure: the operation fails with this typed error."""


class WorkerDeath(InjectedFault):
    """Simulated death of the serving worker (watchdog-recoverable)."""


class DelayFault(InjectedFault):
    """Taxonomy marker for the ``"delay"`` kind: a hit of this kind
    *sleeps* ``FaultInjector.delay_s`` and returns — it is never raised.
    Use it to inject a slow (but successful) dispatch, e.g. to drive the
    ``SearchServer`` roofline-drift monitor out of its band."""


_KINDS = {
    "transient": TransientFault,
    "fatal": FatalFault,
    "death": WorkerDeath,
    "delay": DelayFault,
}


def _check_point(point: str) -> None:
    if point not in INJECTION_POINTS:
        raise ValueError(
            f"unknown injection point {point!r}; known points: "
            f"{INJECTION_POINTS}"
        )


class FaultInjector:
    """Seeded, deterministic decision engine for the injection points.

    Args:
      seed: base seed; each point derives an independent RNG stream from
        ``(seed, crc32(point))`` so points never perturb each other.
      rates: ``{point: probability}`` — each hit of ``point`` fires with
        that probability (kind ``rate_kind``, default transient).
      schedule: ``(point, nth_hit, kind)`` triples — the *nth* hit of
        ``point`` (1-based) fires a fault of ``kind`` ("transient" |
        "fatal" | "death").  Exact and rate-independent: the canonical way
        to script a reproducible chaos scenario.
      rate_kind: the exception kind rate-based fires raise.
      delay_s: wall seconds a ``"delay"``-kind hit sleeps before
        returning (delay fires succeed slowly instead of raising).

    >>> inj = FaultInjector(schedule=[("serve.dispatch", 2, "transient")])
    >>> inj.fire("serve.dispatch")   # hit 1: passes
    >>> try:
    ...     inj.fire("serve.dispatch")  # hit 2: fires
    ... except TransientFault as e:
    ...     print(e.point, e.hit)
    serve.dispatch 2
    """

    def __init__(
        self,
        seed: int = 0,
        rates: Optional[Dict[str, float]] = None,
        schedule: Optional[Iterable[Sequence]] = None,
        rate_kind: str = "transient",
        delay_s: float = 0.05,
    ):
        self.seed = int(seed)
        if delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {delay_s}")
        self.delay_s = float(delay_s)
        self.rates: Dict[str, float] = {}
        for point, p in (rates or {}).items():
            _check_point(point)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"rate for {point!r} must be in [0,1], got {p}")
            self.rates[point] = float(p)
        if rate_kind not in _KINDS:
            raise ValueError(f"rate_kind must be one of {sorted(_KINDS)}")
        self.rate_kind = rate_kind
        self.schedule: Dict[Tuple[str, int], str] = {}
        for entry in schedule or ():
            point, nth, kind = entry
            _check_point(point)
            if kind not in _KINDS:
                raise ValueError(
                    f"schedule kind must be one of {sorted(_KINDS)}, "
                    f"got {kind!r}"
                )
            if int(nth) < 1:
                raise ValueError(f"schedule hits are 1-based, got {nth}")
            self.schedule[(point, int(nth))] = kind
        self.hits: Counter = Counter()
        self.fired: Counter = Counter()
        self._lock = threading.Lock()
        self._rngs: Dict[str, np.random.Generator] = {}
        self.reset()

    def reset(self) -> None:
        """Rewind hit counters and RNG streams to the initial state —
        after which the exact same fire pattern replays."""
        with self._lock:
            self.hits.clear()
            self.fired.clear()
            self._rngs = {
                point: np.random.default_rng(
                    [self.seed, zlib.crc32(point.encode())]
                )
                for point in INJECTION_POINTS
            }

    def fire(self, point: str) -> None:
        """Record one hit of ``point``; raise if the seed/schedule says so."""
        _check_point(point)
        with self._lock:
            self.hits[point] += 1
            hit = self.hits[point]
            kind = self.schedule.get((point, hit))
            if kind is None:
                rate = self.rates.get(point, 0.0)
                # Always draw when a rate is configured, even on non-firing
                # hits — the stream position must depend only on the hit
                # count for determinism.
                if rate > 0.0 and self._rngs[point].random() < rate:
                    kind = self.rate_kind
            if kind is None:
                return
            self.fired[point] += 1
        if kind == "delay":
            # A slowdown, not an error: sleep OUTSIDE the lock (other
            # points keep firing) and return without raising.
            time.sleep(self.delay_s)
            return
        raise _KINDS[kind](point, hit)


# -- process-global registry --------------------------------------------------

_ACTIVE: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    """Install ``injector`` process-globally (index/checkpoint points fire
    through this; ``SearchServer(faults=...)`` can override serve.*)."""
    global _ACTIVE
    _ACTIVE = injector
    return injector


def uninstall() -> None:
    """Remove the global injector; every ``fire()`` becomes a no-op."""
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultInjector]:
    """The globally installed injector, or None."""
    return _ACTIVE


def fire(point: str) -> None:
    """Fire ``point`` on the global injector (no-op when none installed)."""
    if _ACTIVE is not None:
        _ACTIVE.fire(point)


@contextlib.contextmanager
def injected(injector: FaultInjector):
    """Scope an injector: installed on entry, uninstalled on exit.

    >>> with injected(FaultInjector()) as inj:
    ...     active() is inj
    True
    """
    prev = _ACTIVE
    install(injector)
    try:
        yield injector
    finally:
        if prev is None:
            uninstall()
        else:
            install(prev)
