"""Straggler detection & mitigation policy (port of
``src/repro/ft/straggler.py``, numpy only).

On a real multi-pod fleet the controller feeds per-host step times in;
the policy decides when a host is persistently slow (EWMA > k x fleet
median) and emits a mitigation action.  The brief's mitigations:
  * "hot spare": swap the slow host for a standby and restart from the
    latest checkpoint (cheap because checkpoints are atomic + elastic),
  * "shrink": drop the host and re-mesh (ft.elastic) when no spare exists.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

__all__ = ["StragglerPolicy", "Action"]


@dataclasses.dataclass(frozen=True)
class Action:
    kind: str           # "none" | "swap" | "shrink"
    host: Optional[int] = None
    reason: str = ""


class StragglerPolicy:
    def __init__(self, *, threshold: float = 1.5, ewma: float = 0.2,
                 grace_steps: int = 10, min_steps: int = 5):
        self.threshold = threshold
        self.ewma = ewma
        self.grace_steps = grace_steps
        self.min_steps = min_steps
        self._t: Dict[int, float] = {}
        self._slow_streak: Dict[int, int] = {}
        self._steps = 0

    def observe(self, step_times: Dict[int, float]) -> Action:
        """Feed one step of per-host wall times; returns the action to take."""
        self._steps += 1
        for host, t in step_times.items():
            prev = self._t.get(host, t)
            self._t[host] = (1 - self.ewma) * prev + self.ewma * t
        if self._steps < self.min_steps or len(self._t) < 2:
            return Action("none")
        med = float(np.median(list(self._t.values())))
        worst_host, worst = max(self._t.items(), key=lambda kv: kv[1])
        if worst > self.threshold * med:
            streak = self._slow_streak.get(worst_host, 0) + 1
            self._slow_streak = {worst_host: streak}
            if streak >= self.grace_steps:
                return Action(
                    "swap", host=worst_host,
                    reason=f"ewma {worst:.3f}s > {self.threshold}x median {med:.3f}s "
                           f"for {streak} steps",
                )
        else:
            self._slow_streak = {}
        return Action("none")
