"""Flight recorder + metrics registry for the serving stack (DESIGN.md §14).

The paper's pitch is branches retuned at run-time from *observed
conditions*; this module is where the conditions get observed. Two
complementary surfaces share one namespace:

* ``FlightRecorder`` — a bounded ring buffer of typed, monotonic-timestamped
  ``Event`` records. Disabled by default and **compiled out at call sites**:
  instrumented code captures ``recorder if recorder.enabled else None`` once
  and guards every emit with a single ``is not None`` test, so the disabled
  path costs one pointer compare (the overhead contract is gated by
  ``benchmarks/telemetry_bench.py`` in the JAX package). When enabled, the buffer holds the
  last ``capacity`` events — old events fall off the front and are counted
  in ``dropped`` — so a long-running server records a flight-recorder
  window, not an unbounded log. ``runtime/tracing.py`` exports the buffer
  as Chrome trace-event JSON for ui.perfetto.dev.

* ``MetricsRegistry`` — always-on counters, gauges, and fixed-bucket
  histograms, keyed by ``(name, labels)``. ``BatcherStats.lane_calls`` and
  ``latency_report`` *derive from* this registry rather than maintaining
  parallel dicts, so per-lane counters, dispatch telemetry, and the trace
  agree by construction. Snapshots serialise to JSON and to Prometheus
  text exposition format (``to_prometheus``).

``Telemetry`` bundles the two and is what ``Engine``, batchers, and
``PagePool`` accept. This is the port's copy of ``repro.core.telemetry``.
"""

from __future__ import annotations

import json
import threading
import time
from bisect import bisect_left
from typing import Any

__all__ = [
    "Event",
    "FlightRecorder",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Telemetry",
    "DEFAULT_MS_BUCKETS",
]

# Chrome trace-event phases used by the recorder: complete span, instant,
# counter sample (runtime/tracing.py maps these 1:1 into the export).
PH_SPAN = "X"
PH_INSTANT = "i"
PH_COUNTER = "C"

_VALID_PH = (PH_SPAN, PH_INSTANT, PH_COUNTER)


class Event:
    """One flight-recorder record. Timestamps are ``time.perf_counter_ns``."""

    __slots__ = ("ts_ns", "name", "track", "ph", "dur_ns", "args")

    def __init__(
        self,
        ts_ns: int,
        name: str,
        track: str,
        ph: str = PH_INSTANT,
        dur_ns: int = 0,
        args: dict | None = None,
    ):
        self.ts_ns = ts_ns
        self.name = name
        self.track = track
        self.ph = ph
        self.dur_ns = dur_ns
        self.args = args

    def __repr__(self) -> str:  # debugging aid only
        return (
            f"Event({self.name!r}, track={self.track!r}, ph={self.ph!r}, "
            f"ts_ns={self.ts_ns}, dur_ns={self.dur_ns}, args={self.args!r})"
        )


class FlightRecorder:
    """Bounded ring buffer of :class:`Event`.

    The zero-overhead-when-disabled contract: every instrumented call site
    either holds ``None`` instead of the recorder or checks ``enabled``
    before building args dicts. ``emit`` itself also early-returns when
    disabled (belt and braces for sites that cache the recorder).
    """

    def __init__(self, capacity: int = 65536, enabled: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self.t0_ns = time.perf_counter_ns()
        self._buf: list[Event | None] = [None] * self.capacity
        self._next = 0  # total events ever emitted (ring head = _next % cap)
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ emit
    def emit(
        self,
        name: str,
        track: str,
        ph: str = PH_INSTANT,
        ts_ns: int | None = None,
        dur_ns: int = 0,
        args: dict | None = None,
    ) -> None:
        if not self.enabled:
            return
        if ts_ns is None:
            ts_ns = time.perf_counter_ns()
        ev = Event(ts_ns, name, track, ph, dur_ns, args)
        with self._lock:
            self._buf[self._next % self.capacity] = ev
            self._next += 1

    def complete(
        self,
        name: str,
        track: str,
        t0_ns: int,
        args: dict | None = None,
    ) -> None:
        """Emit a complete span ("X") that started at ``t0_ns`` and ends now."""
        if not self.enabled:
            return
        now = time.perf_counter_ns()
        self.emit(name, track, PH_SPAN, ts_ns=t0_ns, dur_ns=now - t0_ns,
                  args=args)

    def counter(self, name: str, track: str, **values: float) -> None:
        """Emit a counter sample ("C") — e.g. pool occupancy over time."""
        if not self.enabled:
            return
        self.emit(name, track, PH_COUNTER, args=dict(values))

    # ----------------------------------------------------------- inspection
    def __len__(self) -> int:
        return min(self._next, self.capacity)

    @property
    def emitted(self) -> int:
        """Total events ever emitted (including those that fell off)."""
        return self._next

    @property
    def dropped(self) -> int:
        """Events lost to ring overflow."""
        return max(0, self._next - self.capacity)

    def events(self) -> list[Event]:
        """Snapshot the ring in emission order (oldest surviving first)."""
        with self._lock:
            n, cap = self._next, self.capacity
            if n <= cap:
                return [e for e in self._buf[:n] if e is not None]
            head = n % cap
            return [
                e for e in self._buf[head:] + self._buf[:head]
                if e is not None
            ]

    def tracks(self) -> list[str]:
        seen: dict[str, None] = {}
        for ev in self.events():
            seen.setdefault(ev.track, None)
        return list(seen)

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._next = 0
            self.t0_ns = time.perf_counter_ns()

# ---------------------------------------------------------------- instruments
# Log-spaced millisecond buckets: 50µs .. 10s, a fixed layout so histograms
# from different runs merge and Prometheus scrapes stay constant-size.
DEFAULT_MS_BUCKETS = (
    0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
    100.0, 200.0, 500.0, 1000.0, 2000.0, 5000.0, 10000.0,
)


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0.0


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Fixed-bucket latency histogram (cumulative export, Prometheus-style).

    ``bounds`` are ascending upper edges; observations above the last bound
    land in the +Inf overflow bucket. Percentiles interpolate linearly
    within the containing bucket (lower edge of the first bucket is 0 —
    observations are assumed non-negative, which holds for every latency
    this stack records), so the estimate is exact to within one bucket
    width (the JAX package's tests/test_telemetry.py checks against numpy).
    """

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...] = DEFAULT_MS_BUCKETS):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"bounds must be ascending, got {bounds!r}")
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # + overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100]; linear interpolation within the containing bucket."""
        if self.count == 0:
            return 0.0
        target = (p / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c > 0:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                # overflow bucket has no finite upper edge: clamp to last bound
                hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.bounds[-1]

    def cumulative(self) -> list[tuple[float, int]]:
        """[(upper_edge, cumulative_count), ...] ending with (inf, count)."""
        out = []
        cum = 0
        for b, c in zip(self.bounds, self.counts[:-1]):
            cum += c
            out.append((b, cum))
        out.append((float("inf"), self.count))
        return out


# ------------------------------------------------------------------ registry
def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Family:
    __slots__ = ("kind", "bounds", "children")

    def __init__(self, kind: str, bounds: tuple[float, ...] | None = None):
        self.kind = kind  # "counter" | "gauge" | "histogram"
        self.bounds = bounds
        self.children: dict[tuple, Any] = {}


class MetricsRegistry:
    """Named, labelled counters/gauges/histograms with JSON + Prometheus out.

    Instruments are created on first use and *reset in place* by
    ``rollover`` — handles cached by hot code paths stay valid across the
    warmup boundary.
    """

    def __init__(self):
        self._families: dict[str, _Family] = {}
        self.sections: dict[str, dict] = {}  # rolled-over snapshots (warmup)

    # ------------------------------------------------------------- get/create
    def _child(self, name: str, kind: str, labels: dict,
               bounds: tuple[float, ...] | None = None):
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(kind, bounds)
        elif fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, "
                f"requested {kind}"
            )
        key = _label_key(labels)
        child = fam.children.get(key)
        if child is None:
            if kind == "counter":
                child = Counter()
            elif kind == "gauge":
                child = Gauge()
            else:
                child = Histogram(fam.bounds or DEFAULT_MS_BUCKETS)
            fam.children[key] = child
        return child

    def counter(self, name: str, **labels) -> Counter:
        return self._child(name, "counter", labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._child(name, "gauge", labels)

    def histogram(self, name: str,
                  bounds: tuple[float, ...] = DEFAULT_MS_BUCKETS,
                  **labels) -> Histogram:
        return self._child(name, "histogram", labels, bounds)

    # ------------------------------------------------------------ convenience
    def inc(self, name: str, n: float = 1.0, **labels) -> None:
        self.counter(name, **labels).inc(n)

    def set(self, name: str, v: float, **labels) -> None:
        self.gauge(name, **labels).set(v)

    def observe(self, name: str, v: float, **labels) -> None:
        self.histogram(name, **labels).observe(v)

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        fam = self._families.get(name)
        if fam is None:
            return default
        child = fam.children.get(_label_key(labels))
        return default if child is None else child.value

    def labeled_values(self, name: str, label: str) -> dict:
        """{label_value: value} across a family — e.g. lane_calls by lane.

        Counter values surface as ints (they count calls/tokens); the dict
        is insertion-ordered by first observation, matching the old
        hand-maintained ``BatcherStats.lane_calls`` behaviour.
        """
        fam = self._families.get(name)
        if fam is None:
            return {}
        out: dict = {}
        for key, child in fam.children.items():
            lv = dict(key).get(label)
            if lv is None:
                continue
            v = child.value
            out[lv] = int(v) if float(v).is_integer() else v
        return out

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """JSON-able snapshot of every live instrument plus rolled sections."""
        counters: dict[str, list] = {}
        gauges: dict[str, list] = {}
        hists: dict[str, list] = {}
        for name, fam in sorted(self._families.items()):
            for key, child in sorted(fam.children.items()):
                labels = dict(key)
                if fam.kind == "counter":
                    v = child.value
                    counters.setdefault(name, []).append(
                        {"labels": labels,
                         "value": int(v) if float(v).is_integer() else v}
                    )
                elif fam.kind == "gauge":
                    gauges.setdefault(name, []).append(
                        {"labels": labels, "value": child.value}
                    )
                else:
                    hists.setdefault(name, []).append({
                        "labels": labels,
                        "count": child.count,
                        "sum": child.sum,
                        "mean": child.mean,
                        "p50": child.percentile(50),
                        "p95": child.percentile(95),
                        "p99": child.percentile(99),
                        "buckets": [
                            {"le": b, "count": c}
                            for b, c in child.cumulative()
                        ],
                    })
        out: dict = {
            "counters": counters, "gauges": gauges, "histograms": hists,
        }
        if self.sections:
            out["sections"] = self.sections
        return out

    def rollover(self, section: str = "warmup") -> dict:
        """Snapshot current values under ``sections[section]``, then zero
        every instrument in place (cached handles stay valid).

        This is the warmup/steady-state boundary: ``Engine`` calls it after
        lane warmup so post-warmup counters read clean by construction.
        """
        snap = self.snapshot()
        snap.pop("sections", None)
        self.sections[section] = snap
        for fam in self._families.values():
            for child in fam.children.values():
                child.reset()
        return snap

    # ------------------------------------------------------------ prometheus
    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        def fmt_labels(labels: dict, extra: str = "") -> str:
            parts = [
                f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())
            ]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        def _escape(s: str) -> str:
            return s.replace("\\", "\\\\").replace('"', '\\"')

        def fmt_num(v: float) -> str:
            return str(int(v)) if float(v).is_integer() else repr(float(v))

        lines: list[str] = []
        for name, fam in sorted(self._families.items()):
            if fam.kind == "counter":
                lines.append(f"# TYPE {name} counter")
                for key, child in sorted(fam.children.items()):
                    lines.append(
                        f"{name}{fmt_labels(dict(key))} "
                        f"{fmt_num(child.value)}"
                    )
            elif fam.kind == "gauge":
                lines.append(f"# TYPE {name} gauge")
                for key, child in sorted(fam.children.items()):
                    lines.append(
                        f"{name}{fmt_labels(dict(key))} "
                        f"{fmt_num(child.value)}"
                    )
            else:
                lines.append(f"# TYPE {name} histogram")
                for key, child in sorted(fam.children.items()):
                    labels = dict(key)
                    for b, cum in child.cumulative():
                        le = "+Inf" if b == float("inf") else fmt_num(b)
                        le_label = 'le="' + le + '"'
                        lines.append(
                            f"{name}_bucket"
                            f"{fmt_labels(labels, le_label)} {cum}"
                        )
                    lines.append(
                        f"{name}_sum{fmt_labels(labels)} "
                        f"{fmt_num(child.sum)}"
                    )
                    lines.append(
                        f"{name}_count{fmt_labels(labels)} {child.count}"
                    )
        return "\n".join(lines) + "\n"


# ------------------------------------------------------------------- facade
class Telemetry:
    """What the engine and runtime layers thread around.

    * ``recorder`` — the flight recorder; **disabled by default** so the
      hot path pays one pointer compare, nothing else.
    * ``registry`` — always-on metrics (lane_calls, latency histograms);
      this is what ``latency_report`` derives from.
    * ``compile_analysis`` — when True, ``Engine._build`` runs
      ``capture_analysis.analyze_target`` on every freshly built target and
      appends a per-DispatchKey report to ``compile_reports``.
    """

    def __init__(
        self,
        enabled: bool = False,
        capacity: int = 65536,
        compile_analysis: bool = False,
    ):
        self.recorder = FlightRecorder(capacity=capacity, enabled=enabled)
        self.registry = MetricsRegistry()
        self.compile_analysis = bool(compile_analysis)
        self.compile_reports: list[dict] = []

    @property
    def enabled(self) -> bool:
        return self.recorder.enabled

    def enable(self) -> None:
        self.recorder.enabled = True

    def disable(self) -> None:
        self.recorder.enabled = False

    def trace_or_none(self) -> FlightRecorder | None:
        """The call-site guard: hold the recorder only when it records."""
        return self.recorder if self.recorder.enabled else None

    def metrics_json(self) -> str:
        return json.dumps(self.registry.snapshot(), indent=2, sort_keys=True)
