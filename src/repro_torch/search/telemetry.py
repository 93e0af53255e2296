"""Thread-safe counters behind the port's observability hooks.

Port of the ``AtomicCounter`` of ``src/repro/search/telemetry.py``; the
registry, request traces and drift monitor come with the serving slice.
"""
from __future__ import annotations

import collections
import threading

__all__ = ["AtomicCounter"]


class AtomicCounter(collections.Counter):
    """A ``collections.Counter`` whose increments are atomic.

    ``counter[k] += 1`` is a read-modify-write that two threads can
    interleave and lose; ``inc`` performs it under a lock.

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
