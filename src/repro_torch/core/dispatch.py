"""Unified dispatch core: the paper's construct as one layered mechanism.

The port's copy of ``repro.core.dispatch`` (DESIGN.md §3). It joins a **hot
slot** — a ``BranchChanger``-style single mutable entry point, rebound on the
cold path, called directly on the hot path (the patched-``jmp`` analogue) —
and an **open fan-out table** — key -> branch target, built on first sight of
a key — into a single ``Dispatcher``. In the port a branch target is the
step callable specialised on the key's static shapes; capturing it as a CUDA
graph is later work.

    key --> CompileCache (single-flight builds)
        --> DispatchPolicy (hysteresis: when is a rebind worth it?)
        --> hot slot (direct call, no hashing, no conditionals)

The ``DispatchPolicy`` makes the paper's Fig. 13 result a first-class knob:
switching the branch direction is cheap but *not free*, so when the key
oscillates rapidly (greedy/sample/greedy/sample...) the policy can refuse to
thrash the slot and serve the minority key straight from the table — the
table lookup costs one dict hit, while a rebind costs a slot write.
Hysteresis = N means a key must be seen N times in a row
before it captures the slot.

The ``CompileCache`` closes the paper's §5.2 duplicate-entry-point hazard in
table form: two cold-path threads racing to build the same key would
otherwise both pay the build and one result would be silently dropped.
Builds are single-flight — one leader builds, followers block on an event
and reuse the leader's target.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable


class DispatchError(RuntimeError):
    """Raised for dispatcher misuse that would be undefined behaviour."""


# --------------------------------------------------------------------- cache
@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    single_flight_waits: int = 0
    compile_seconds: float = 0.0
    keys: list = field(default_factory=list)


class _Build:
    """In-flight build record: followers wait on ``event``."""

    __slots__ = ("event", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.error: BaseException | None = None


class CompileCache:
    """key -> branch target, with single-flight cold-path builds: on a miss
    exactly one caller runs ``builder()`` (the leader); concurrent callers
    for the same key block until the leader finishes and then reuse its
    target."""

    def __init__(self, name: str = "cache", recorder: Any = None):
        self.name = name
        self._table: dict[Hashable, Any] = {}
        self._building: dict[Hashable, _Build] = {}
        self._lock = threading.Lock()
        self.stats = CacheStats()
        # Optional flight recorder (core.telemetry.FlightRecorder): build
        # spans land on the "dispatcher" trace track, tagged with their key.
        self.recorder = recorder

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._table

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)

    def get_or_build(self, key: Hashable, builder: Callable[[], Any]) -> Any:
        """Cold path: build-and-insert on miss, single-flight per key."""
        while True:
            with self._lock:
                if key in self._table:
                    self.stats.hits += 1
                    return self._table[key]
                build = self._building.get(key)
                if build is None:
                    build = _Build()
                    self._building[key] = build
                    leader = True
                else:
                    leader = False
                    self.stats.single_flight_waits += 1
            if leader:
                rec = self.recorder
                t0_ns = (
                    time.perf_counter_ns()
                    if rec is not None and rec.enabled else 0
                )
                t0 = time.perf_counter()
                try:
                    exe = builder()
                except BaseException as e:
                    with self._lock:
                        build.error = e
                        del self._building[key]
                    build.event.set()
                    raise
                build_s = time.perf_counter() - t0
                with self._lock:
                    self._table[key] = exe
                    self.stats.misses += 1
                    self.stats.keys.append(key)
                    self.stats.compile_seconds += build_s
                    del self._building[key]
                build.event.set()
                if t0_ns:  # build span, tagged with its dispatch key
                    rec.complete(
                        "compile", "dispatcher", t0_ns,
                        args={"key": str(key),
                              "build_ms": round(build_s * 1e3, 3)},
                    )
                return exe
            # Follower: wait for the leader, then retry the lookup (the
            # leader may have failed; then loop and become the leader).
            build.event.wait()


# -------------------------------------------------------------------- policy
@dataclass(frozen=True)
class DispatchPolicy:
    """When does a key deserve the hot slot? (paper Fig. 13, as policy)

    hysteresis   — a non-current key must be dispatched this many times in a
                   row before the slot rebinds to it. 1 = classic
                   ``BranchChanger`` behaviour (rebind immediately); higher
                   values keep the slot stable under rapid oscillation, at
                   the cost of serving the minority key from the table.
    """

    hysteresis: int = 1

    def __post_init__(self) -> None:
        if self.hysteresis < 1:
            raise DispatchError(
                f"hysteresis must be >= 1, got {self.hysteresis}"
            )


class DispatchStats:
    """Slot/table/build counters; cache counters are delegated."""

    def __init__(self, cache: CompileCache):
        self._cache = cache
        self.slot_hits = 0  # dispatches served by the hot slot
        self.table_dispatches = 0  # served from the table without rebinding
        self.rebinds = 0
        self.suppressed_rebinds = 0  # hysteresis said "not yet"

    @property
    def hits(self) -> int:
        return self.slot_hits + self._cache.stats.hits

    @property
    def misses(self) -> int:
        """Builds. The serving acceptance metric: after warmup a
        continuous-batching stream must not move this counter."""
        return self._cache.stats.misses

    @property
    def compile_seconds(self) -> float:
        return self._cache.stats.compile_seconds

    def snapshot(self) -> dict:
        return {
            "slot_hits": self.slot_hits,
            "table_dispatches": self.table_dispatches,
            "rebinds": self.rebinds,
            "suppressed_rebinds": self.suppressed_rebinds,
            "builds": self.misses,
        }


# ---------------------------------------------------------------- dispatcher
# One live Dispatcher per entry-point name (paper §5.2: multiple instances
# sharing an entry point silently fight over it -> undefined behaviour).
_DISPATCHERS: dict[str, "Dispatcher"] = {}
_REGISTRY_LOCK = threading.Lock()


class Dispatcher:
    """Open-fan-out semi-static condition with a single hot slot.

    ``builder(key)`` produces the branch target for a key (the step
    callable specialised on the key's static shapes); it runs on the cold
    path only, at most once per key (single-flight). ``dispatch(key)``
    returns the target for a key and manages the hot slot per the policy;
    the caller then calls it directly — the patched-``jmp`` hot path.

    The slot rebind is a single reference assignment (the Python analogue of
    the paper's 4-byte ``memcpy``): atomic w.r.t. concurrent hot-path
    readers, single-writer safe without locks.
    """

    def __init__(
        self,
        builder: Callable[[Hashable], Any],
        *,
        name: str | None = None,
        policy: DispatchPolicy | None = None,
        recorder: Any = None,
    ):
        self._builder = builder
        self.policy = policy or DispatchPolicy()
        self._name = name or f"dispatch@{id(self):x}"
        # Flight recorder shared with the cache: build spans come from the
        # cache, rebind + hysteresis events from here. The slot fast path
        # never touches it.
        self.recorder = recorder
        self.cache = CompileCache(name=self._name, recorder=recorder)
        self._current: Callable | None = None  # the hot slot
        self._current_key: Hashable | None = None
        self._candidate: Hashable | None = None
        self._streak = 0
        self.stats = DispatchStats(self.cache)
        with _REGISTRY_LOCK:
            if self._name in _DISPATCHERS:
                raise DispatchError(
                    f"More than one Dispatcher for entry point "
                    f"{self._name!r}; multiple instances sharing an entry "
                    f"point is undefined behaviour (paper §5.2). Pass a "
                    f"unique name=..., or close() the old one."
                )
            _DISPATCHERS[self._name] = self

    # ------------------------------------------------------------ properties
    @property
    def name(self) -> str:
        return self._name

    @property
    def current_key(self) -> Hashable | None:
        return self._current_key

    @property
    def current(self) -> Callable | None:
        return self._current

    def __contains__(self, key: Hashable) -> bool:
        return key in self.cache

    def __len__(self) -> int:
        return len(self.cache)

    # ------------------------------------------------------------- cold path
    def build(self, key: Hashable) -> Any:
        """Build (or fetch) a key without touching the slot or the policy
        streak — pure prebuilding (the warm-everything pattern)."""
        return self.cache.get_or_build(key, lambda: self._builder(key))

    def dispatch(self, key: Hashable) -> Any:
        """Return the branch target for ``key``; maybe rebind the hot slot.

        Fast case: ``key`` already owns the slot — one equality check, no
        dict, no lock. Otherwise the target is fetched/built from the cache
        and the hysteresis policy decides whether the slot moves.
        """
        if key == self._current_key and self._current is not None:
            self.stats.slot_hits += 1
            # A sighting of the slot's own key breaks any rival streak:
            # hysteresis counts *consecutive* dispatches of a challenger.
            self._candidate = key
            return self._current
        exe = self.build(key)
        if key == self._candidate:
            self._streak += 1
        else:
            self._candidate = key
            self._streak = 1
        if self._streak >= self.policy.hysteresis:
            self._rebind(key, exe)
        else:
            self.stats.suppressed_rebinds += 1
            self.stats.table_dispatches += 1
            rec = self.recorder
            if rec is not None and rec.enabled:
                rec.emit(
                    "rebind_suppressed", "dispatcher",
                    args={"key": str(key), "streak": self._streak,
                          "hysteresis": self.policy.hysteresis},
                )
        return exe

    def _rebind(self, key: Hashable, exe: Callable) -> None:
        old = self._current_key
        self._current = exe  # <- the "jmp patch"
        self._current_key = key
        self._candidate = key
        self._streak = self.policy.hysteresis  # saturate
        self.stats.rebinds += 1
        rec = self.recorder
        if rec is not None and rec.enabled:  # the hot-slot flip itself
            rec.emit(
                "rebind", "dispatcher",
                args={"key": str(key),
                      "from": None if old is None else str(old)},
            )

    # ----------------------------------------------------------------- admin
    def close(self) -> None:
        with _REGISTRY_LOCK:
            _DISPATCHERS.pop(self._name, None)

    def __enter__(self) -> "Dispatcher":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
