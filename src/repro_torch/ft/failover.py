"""Fault tolerance: heartbeats, straggler watchdog, and semi-static failover.

The port's copy of ``repro.ft.failover``, over the port's ``Dispatcher``.

The paper's construct as a *reliability* mechanism (DESIGN.md §6): the
degraded step sits behind the same unified dispatch core the serving
engine uses (``core.dispatch.Dispatcher``) — health states are
dispatch keys, step callables are the cached branch targets. Failure
detection runs in the cold path (between steps); failing over is one forced
slot rebind (``set_direction``) — the hot loop (``plan.step(...)``) never
evaluates a health conditional.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ..core import DispatchPolicy, Dispatcher

HEALTHY, DEGRADED = True, False  # dispatch-key semantics (paper's if/else)


class HeartbeatMonitor:
    """Tracks last-seen times per worker; stale workers are failures."""

    def __init__(self, workers: list[str], timeout_s: float = 10.0):
        self.timeout_s = timeout_s
        now = time.monotonic()
        self._last: dict[str, float] = {w: now for w in workers}

    def beat(self, worker: str, t: float | None = None) -> None:
        self._last[worker] = time.monotonic() if t is None else t

    def failed(self, now: float | None = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return [w for w, t in self._last.items() if now - t > self.timeout_s]

    def healthy(self) -> bool:
        return not self.failed()


class StepTimeWatchdog:
    """EMA-based straggler detection on observed step times."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0, warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self._ema: float | None = None
        self._n = 0
        self.events: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step looks like a straggler."""
        self._n += 1
        if self._ema is None:
            self._ema = dt
            return False
        straggler = (
            self._n > self.warmup and dt > self.threshold * self._ema
        )
        if straggler:
            self.events.append((step, dt, self._ema))
        else:
            self._ema = (1 - self.alpha) * self._ema + self.alpha * dt
        return straggler


@dataclass
class FailoverPlan:
    """Healthy/degraded step executables behind one semi-static entry point.

    healthy_fn / degraded_fn are step callables (typically built ahead for
    the full and the reduced set of devices). ``reshard_fn(state) -> state`` moves the
    live state onto the degraded layout when failover triggers.
    """

    healthy_fn: Callable
    degraded_fn: Callable
    reshard_fn: Callable | None = None
    name: str = "ft-step"
    on_failover: list = field(default_factory=list)

    def __post_init__(self) -> None:
        # Health states as dispatch keys on the unified core. Hysteresis is 1:
        # a failover must take effect on the very next step, never be
        # suppressed as "oscillation".
        self._dsp = Dispatcher(
            lambda healthy: self.healthy_fn if healthy else self.degraded_fn,
            name=self.name,
            policy=DispatchPolicy(hysteresis=1),
        )
        self._dsp.set_direction(HEALTHY)
        self.failovers = 0

    @property
    def degraded(self) -> bool:
        return self._dsp.current_key == DEGRADED

    def check(self, monitor: HeartbeatMonitor, state: Any) -> Any:
        """Cold path: called between steps. Returns (possibly resharded) state."""
        if not self.degraded and not monitor.healthy():
            if self.reshard_fn is not None:
                state = self.reshard_fn(state)
            self._dsp.set_direction(DEGRADED)  # forced rebind, no hysteresis
            self.failovers += 1
            for cb in self.on_failover:
                cb(monitor.failed())
        return state

    def step(self, *args: Any) -> Any:
        """Hot path: direct call of the current executable."""
        return self._dsp.hot(*args)

    def close(self) -> None:
        self._dsp.close()
