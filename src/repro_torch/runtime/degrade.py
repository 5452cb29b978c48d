"""Semi-static degradation ladder (DESIGN.md §15).

The port's copy of ``repro.runtime.degrade`` (pure host control).

`ft.failover.FailoverPlan` dispatches the *training* step between two
health states. This module generalises the idea to the serving engine as a
multi-rung ladder: an overload controller reads the metrics registry's
observation space (queue depth, pool occupancy, p95 step time) and steps the engine down through *already-warmed* dispatch
coordinates:

    healthy -> spec off -> minimum chunk buckets -> trimmed token budget
            -> int8 KV pool

Every actuation is pure host data over keys warmup built (captured CUDA
graphs on the card) — the batcher's ``set_knobs`` clamps into the launch
ranges, so a rung change is at most a hysteresis-guarded rebind on the next
step, never a build.
Recovery is symmetric: when the load signals clear, the controller walks
back up one rung at a time under the same hysteresis.

This is the paper's semi-static branch with the direction set by load: the
hot path never tests "are we overloaded?" — the controller flips the
branch from the cold path, and the hot path just runs whichever warmed
target the knobs now select. The learned policy that would drive it is
still open.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Rung:
    """One ladder position: absolute knob values (None = launch value).

    Rungs are cumulative by construction — ``default_ladder`` makes each
    rung carry every restriction of the rungs above it, so the controller
    only ever applies the current rung, never a composition.
    """

    name: str
    spec_k: int | None = None
    prefill_chunk: int | None = None
    token_budget: int | None = None
    kv_dtype: str | None = None


def default_ladder(
    *,
    spec_k: int = 0,
    prefill_chunk: int = 0,
    token_budget: int = 0,
    min_chunk: int = 8,
    int8_pool: bool = False,
) -> tuple[Rung, ...]:
    """Build the standard ladder from the launch knobs, skipping rungs the
    engine can't actually express (no spec lanes -> no spec-off rung)."""
    rungs = [Rung("healthy")]
    shed: dict = {}
    if spec_k > 0:
        shed["spec_k"] = 0
        rungs.append(Rung("spec-off", **shed))
    if prefill_chunk > min_chunk:
        shed["prefill_chunk"] = min_chunk
        rungs.append(Rung("chunk-min", **shed))
    if token_budget > 0:
        shed["token_budget"] = max(token_budget // 2, 1)
        rungs.append(Rung("budget-trim", **shed))
    if int8_pool:
        shed["kv_dtype"] = "int8"
        rungs.append(Rung("int8-pool", **shed))
    return tuple(rungs)


class DegradeController:
    """Hysteresis-guarded overload controller over a rung ladder.

    ``observe()`` once per scheduler iteration with the current load
    signals; it returns the new :class:`Rung` when the ladder position
    moved (the caller actuates it via :func:`apply_rung`), else None.

    * overload = any high-threshold breach (queue depth, pool occupancy,
      p95 step time) or a watchdog straggler this iteration;
    * clear    = every signal below its low threshold (the low/high gap is
      the same idea as the Dispatcher's rebind hysteresis — flapping load
      must not flap the ladder);
    * ``hysteresis`` consecutive overloaded (clear) observations move one
      rung down (up);
    * heartbeat loss overrides everything: the engine drops to the bottom
      rung immediately — maximum shedding while a component is missing —
      and recovers through normal hysteresis once beats resume.
    """

    def __init__(
        self,
        rungs,
        *,
        registry=None,
        trace=None,
        queue_high: int = 16,
        queue_low: int = 2,
        pool_high: float = 0.95,
        pool_low: float = 0.75,
        p95_high_ms: float | None = None,
        p95_low_ms: float | None = None,
        hysteresis: int = 3,
    ):
        self.rungs = tuple(rungs)
        if not self.rungs:
            raise ValueError("need at least one rung")
        if hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
        self.registry = registry
        self._trace = trace
        self.queue_high = queue_high
        self.queue_low = queue_low
        self.pool_high = pool_high
        self.pool_low = pool_low
        self.p95_high_ms = p95_high_ms
        self.p95_low_ms = p95_low_ms
        self.hysteresis = hysteresis
        self.idx = 0
        self._over = 0
        self._clear = 0
        self._forced = False  # heartbeat loss pinned us to the bottom
        self._dwell_t0: float | None = None
        self.transitions: list[tuple[float, str, str, str]] = []

    @property
    def rung(self) -> Rung:
        return self.rungs[self.idx]

    # --------------------------------------------------------------- control
    def observe(
        self,
        now: float,
        *,
        queue_depth: int = 0,
        pool_frac: float = 0.0,
        p95_step_ms: float | None = None,
        straggler: bool = False,
        healthy: bool = True,
    ):
        """Feed one iteration's load signals; returns the new Rung on a
        ladder move, else None."""
        if self._dwell_t0 is None:
            self._dwell_t0 = now
        if not healthy:
            # component loss: shed everything sheddable, right now
            self._over = 0
            self._clear = 0
            self._forced = True
            if self.idx < len(self.rungs) - 1:
                return self._move(now, len(self.rungs) - 1, "heartbeat")
            return None
        self._forced = False
        over = (
            queue_depth >= self.queue_high
            or pool_frac >= self.pool_high
            or (
                self.p95_high_ms is not None
                and p95_step_ms is not None
                and p95_step_ms >= self.p95_high_ms
            )
            or straggler
        )
        clear = (
            queue_depth <= self.queue_low
            and pool_frac <= self.pool_low
            and not straggler
            and (
                self.p95_low_ms is None
                or p95_step_ms is None
                or p95_step_ms <= self.p95_low_ms
            )
        )
        if over:
            self._over += 1
            self._clear = 0
            if (
                self._over >= self.hysteresis
                and self.idx < len(self.rungs) - 1
            ):
                self._over = 0
                return self._move(now, self.idx + 1, "overload")
        elif clear:
            self._clear += 1
            self._over = 0
            if self._clear >= self.hysteresis and self.idx > 0:
                self._clear = 0
                return self._move(now, self.idx - 1, "recovered")
        else:
            # between thresholds: hold position, reset both streaks
            self._over = 0
            self._clear = 0
        return None

    def _move(self, now: float, to: int, why: str) -> Rung:
        src, dst = self.rungs[self.idx], self.rungs[to]
        direction = "down" if to > self.idx else "up"
        self._flush_dwell(now)  # dwell lands on the rung we are leaving
        self.idx = to
        self.transitions.append((now, src.name, dst.name, why))
        if self.registry is not None:
            self.registry.inc(
                "degrade_transitions_total", direction=direction
            )
            self.registry.set("degrade_rung", float(to))
        if self._trace is not None:
            self._trace.emit(
                "degrade", "scheduler",
                args={"from": src.name, "to": dst.name, "why": why},
            )
        return dst

    def _flush_dwell(self, now: float) -> None:
        if self._dwell_t0 is not None and self.registry is not None:
            dt = max(now - self._dwell_t0, 0.0)
            self.registry.inc(
                "degrade_rung_dwell_s", dt, rung=self.rung.name
            )
        self._dwell_t0 = now

    def finalize(self, now: float) -> None:
        """Flush the current rung's dwell time into the registry (call
        once when the stream ends, before reporting)."""
        self._flush_dwell(now)


def apply_rung(batcher, rung: Rung, base: Rung) -> dict:
    """Actuate a rung on a batcher: every knob is either the rung's value
    or the launch value captured in ``base``. Pure data over warmed keys;
    the ``kv_dtype`` axis is the serving loop's (it routes admissions
    between pre-warmed pools — a batcher cannot requantise a live cache).
    """
    return batcher.set_knobs(
        spec_k=rung.spec_k if rung.spec_k is not None else base.spec_k,
        prefill_chunk=(
            rung.prefill_chunk
            if rung.prefill_chunk is not None
            else base.prefill_chunk
        ),
        token_budget=(
            rung.token_budget
            if rung.token_budget is not None
            else base.token_budget
        ),
    )
