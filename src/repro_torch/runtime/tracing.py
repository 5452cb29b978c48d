"""Chrome trace-event / Perfetto export of the flight recorder (DESIGN.md §14).

The port's copy of ``repro.runtime.tracing``, over the port's recorder.

Maps the ``core.telemetry.FlightRecorder`` ring buffer onto the Chrome
trace-event JSON object format — the dialect ui.perfetto.dev and
chrome://tracing both open directly:

* one *track* (thread) per event source: ``dispatcher`` for compile /
  rebind / eviction activity, ``page-pool`` for KV page lifecycle and
  occupancy counters, ``scheduler`` for request lifecycle and the async
  issue/park/commit pipeline, and one ``lane:<name>`` track per serving
  lane (cb, cbp, pf, pfd, vf, vfd, dr, drp, burst);
* ``ph:"X"`` complete spans (per-lane step calls, compiles, d2h pulls),
  ``ph:"i"`` instants (rebinds, admits, preemptions, spec rollbacks),
  ``ph:"C"`` counter samples (pool occupancy) — all timestamps in µs
  relative to the recorder's epoch;
* ``ph:"M"`` metadata events naming the process and each track.

Capture with ``python -m repro_torch.launch.serve ... --trace-out trace.json``
and drop the file on https://ui.perfetto.dev. ``validate_trace`` and
``parse_prometheus`` check the two exports, the trace and the registry's
Prometheus text.
"""

from __future__ import annotations

import json
import re
from typing import IO

from ..core.telemetry import (
    PH_COUNTER,
    PH_INSTANT,
    PH_SPAN,
    Event,
    FlightRecorder,
)

__all__ = [
    "TRACK_DISPATCH",
    "TRACK_POOL",
    "TRACK_SCHED",
    "lane_track",
    "chrome_trace",
    "write_trace",
    "validate_trace",
    "parse_prometheus",
]

# Canonical track names — the instrumentation in core/dispatch.py,
# runtime/scheduler.py, and runtime/kvcache.py all emit onto these.
TRACK_DISPATCH = "dispatcher"
TRACK_POOL = "page-pool"
TRACK_SCHED = "scheduler"

# Fixed tids keep track ordering stable across runs; lanes follow.
_PINNED_TIDS = {TRACK_DISPATCH: 1, TRACK_SCHED: 2, TRACK_POOL: 3}
_LANE_TID_BASE = 10
_PID = 1


def lane_track(lane: str) -> str:
    """Track name for a serving lane (one Perfetto row per lane)."""
    return f"lane:{lane}"


def _track_ids(events: list[Event]) -> dict[str, int]:
    tids = dict(_PINNED_TIDS)
    nxt = _LANE_TID_BASE
    for ev in events:
        if ev.track not in tids:
            tids[ev.track] = nxt
            nxt += 1
    return tids


def chrome_trace(recorder: FlightRecorder) -> dict:
    """Render the ring buffer as a Chrome trace-event JSON object."""
    events = recorder.events()
    tids = _track_ids(events)
    base_ns = min((ev.ts_ns for ev in events), default=recorder.t0_ns)

    out: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": _PID,
            "tid": 0,
            "args": {"name": "repro-serving"},
        }
    ]
    for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        out.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": _PID,
                "tid": tid,
                "args": {"name": track},
            }
        )

    for ev in events:
        rec: dict = {
            "name": ev.name,
            "ph": ev.ph,
            "ts": (ev.ts_ns - base_ns) / 1e3,  # µs
            "pid": _PID,
            "tid": tids[ev.track],
        }
        if ev.ph == PH_SPAN:
            rec["dur"] = ev.dur_ns / 1e3
        if ev.ph == PH_INSTANT:
            rec["s"] = "t"  # thread-scoped instant
        if ev.args:
            rec["args"] = ev.args
        out.append(rec)

    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "emitted": recorder.emitted,
            "dropped": recorder.dropped,
            "capacity": recorder.capacity,
        },
    }


def write_trace(path: str | IO[str], recorder: FlightRecorder) -> dict:
    """Write ``chrome_trace(recorder)`` as JSON; returns the trace dict."""
    trace = chrome_trace(recorder)
    if hasattr(path, "write"):
        json.dump(trace, path)
    else:
        with open(path, "w") as fh:
            json.dump(trace, fh)
    return trace


def validate_trace(trace: dict) -> list[str]:
    """Schema sanity for a rendered trace; returns a list of problems.

    An empty list means the file will open in ui.perfetto.dev.
    """
    problems: list[str] = []
    evs = trace.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    valid_ph = {PH_SPAN, PH_INSTANT, PH_COUNTER, "M", "B", "E"}
    for i, ev in enumerate(evs):
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                problems.append(f"event {i} missing {field!r}")
        if ev.get("ph") not in valid_ph:
            problems.append(f"event {i} bad ph {ev.get('ph')!r}")
        if ev.get("ph") != "M" and "ts" not in ev:
            problems.append(f"event {i} missing ts")
        if ev.get("ph") == PH_SPAN and "dur" not in ev:
            problems.append(f"event {i} span missing dur")
    return problems


# One sample of the text exposition: name{label="value",...} value
_PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{([a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})? '
    r'[-+]?([0-9.]+([eE][-+]?[0-9]+)?|inf|Inf|NaN)$')


def parse_prometheus(text: str) -> dict:
    """Check Prometheus text exposition (``MetricsRegistry.to_prometheus``)
    line by line: ``# TYPE name kind`` lines and ``name{labels} value``
    samples, nothing else. Returns ``{"types": {name: kind}, "samples":
    n}``; raises ``ValueError`` on any other line."""
    types: dict[str, str] = {}
    samples = 0
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram"):
                raise ValueError(f"prometheus TYPE line {line!r}")
            types[parts[2]] = parts[3]
        elif _PROM_SAMPLE.match(line):
            samples += 1
        else:
            raise ValueError(f"prometheus line {line!r}")
    return {"types": types, "samples": samples}
