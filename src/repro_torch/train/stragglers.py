"""Straggler mitigation + preemption handling, a copy of
``repro.train.stragglers`` (pure Python).

On a real multi-pod fleet, slow hosts show up as step-time outliers. The
watchdog keeps an EWMA of step latency; a step exceeding ``threshold`` x the
EWMA marks its host suspect, and after ``strikes`` consecutive marks the
policy fires: for input stragglers, redistribute the suspect's shards to
backups (``reassignment``); for compute stragglers the caller triggers an
elastic re-mesh that drops the host (train/elastic.py). A PreemptionGuard
turns SIGTERM into a checkpoint-then-exit. The decision logic is pure and
unit-tested; the signal path is exercised in tests via direct invocation.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class StepTimer:
    ewma: float = 0.0
    beta: float = 0.9
    n: int = 0

    def update(self, dt: float) -> float:
        self.n += 1
        if self.n == 1:
            self.ewma = dt
        else:
            self.ewma = self.beta * self.ewma + (1 - self.beta) * dt
        return self.ewma


@dataclasses.dataclass
class StragglerWatchdog:
    n_hosts: int
    threshold: float = 2.0
    strikes_to_act: int = 3
    timer: StepTimer = dataclasses.field(default_factory=StepTimer)
    strikes: Dict[int, int] = dataclasses.field(default_factory=dict)
    evicted: List[int] = dataclasses.field(default_factory=list)

    def observe(self, host_times: Dict[int, float]) -> List[int]:
        """Feed per-host step times; returns hosts to evict this round."""
        mean = sum(host_times.values()) / max(len(host_times), 1)
        self.timer.update(mean)
        to_evict = []
        for h, t in host_times.items():
            if h in self.evicted:
                continue
            if self.timer.ewma > 0 and t > self.threshold * self.timer.ewma:
                self.strikes[h] = self.strikes.get(h, 0) + 1
            else:
                self.strikes[h] = 0
            if self.strikes.get(h, 0) >= self.strikes_to_act:
                to_evict.append(h)
        for h in to_evict:
            self.evicted.append(h)
        return to_evict

    def reassignment(self, shards_per_host: Dict[int, List[int]]
                     ) -> Dict[int, List[int]]:
        """Redistribute evicted hosts' data shards round-robin to survivors."""
        survivors = [h for h in shards_per_host if h not in self.evicted]
        if not survivors:
            raise RuntimeError("all hosts evicted")
        out = {h: list(s) for h, s in shards_per_host.items()
               if h not in self.evicted}
        orphan = [s for h in self.evicted
                  for s in shards_per_host.get(h, [])]
        for i, s in enumerate(orphan):
            out[survivors[i % len(survivors)]].append(s)
        return out


class PreemptionGuard:
    """SIGTERM -> set flag; train loop checkpoints and exits cleanly."""

    def __init__(self, install: bool = True):
        self.preempted = False
        if install:
            try:
                signal.signal(signal.SIGTERM, self._handler)
            except ValueError:
                pass  # not on main thread (tests)

    def _handler(self, signum, frame):
        self.preempted = True

    def trigger(self):  # for tests
        self.preempted = True
