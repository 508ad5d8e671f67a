"""Fault-tolerance controls: heartbeat + straggler policy. A copy of
``repro.train.monitor`` (pure Python), recording through
``repro_torch.obs``.

On a real multi-host deployment each host runs a ``HeartbeatMonitor``
against a shared store; a host whose heartbeat lapses past ``timeout_s``
is declared failed, and the job controller restarts the worker set from
the latest checkpoint (the trainer's auto-resume path). Straggler
mitigation is policy-driven: per-step wall-time is tracked with an EWMA,
and steps slower than ``slow_factor`` x EWMA raise a straggler event.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch import obs


@dataclasses.dataclass
class StragglerPolicy:
    slow_factor: float = 3.0
    ewma_alpha: float = 0.1
    grace_steps: int = 5         # ignore warmup/compile steps
    on_straggler: Callable[[int, float, float], None] | None = None

    def __post_init__(self):
        self._ewma: float | None = None
        self._events: list[tuple[int, float, float]] = []
        self._n = 0

    @property
    def events(self):
        return list(self._events)

    def observe(self, step: int, dt: float) -> bool:
        """Record a step time; returns True if flagged as straggling."""
        self._n += 1
        if self._n <= self.grace_steps:
            return False
        if self._ewma is None:
            self._ewma = dt
            return False
        flagged = dt > self.slow_factor * self._ewma
        if flagged:
            self._events.append((step, dt, self._ewma))
            obs.metrics().counter("train.straggler_events").inc()
            tr = obs.tracer()
            if tr.enabled:
                tr.instant("straggler", lane="train", step=step, dt_s=dt,
                           ewma_s=self._ewma)
            if self.on_straggler:
                self.on_straggler(step, dt, self._ewma)
        # EWMA excludes flagged outliers so one straggle doesn't mask the next
        if not flagged:
            self._ewma = (1 - self.ewma_alpha) * self._ewma \
                + self.ewma_alpha * dt
        return flagged


@dataclasses.dataclass
class HeartbeatMonitor:
    """Deadline-based liveness tracker for a set of workers."""

    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self._last: dict[str, float] = {}
        self._reported: set[str] = set()

    def beat(self, worker: str) -> None:
        self._last[worker] = self.clock()
        self._reported.discard(worker)    # recovered: next lapse counts anew

    def dead_workers(self) -> list[str]:
        now = self.clock()
        dead = [w for w, t in self._last.items()
                if now - t > self.timeout_s]
        # count each lapse once (polling healthy() must not re-count)
        fresh = [w for w in dead if w not in self._reported]
        if fresh:
            self._reported.update(fresh)
            obs.metrics().counter("train.heartbeat_lapses").inc(len(fresh))
            tr = obs.tracer()
            if tr.enabled:
                for w in fresh:
                    tr.instant("heartbeat_lapse", lane="train", worker=w)
        return dead

    def healthy(self) -> bool:
        return not self.dead_workers()
