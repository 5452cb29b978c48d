"""The port's telemetry export (DESIGN.md §14) against the JAX package (the
twin of ``tests/test_telemetry.py``'s export half).

The same call sequence through both packages gives the same
``MetricsRegistry`` snapshot and Prometheus text (``observe``, ``value``,
``to_prometheus``, labels needing escapes, a rollover), the same
``FlightRecorder`` ring accounting (``emitted``, ``dropped``, ``len``,
``tracks``, ``clear``), the same ``Telemetry`` switches and
``metrics_json``, the same Chrome trace of the same events (timestamps
given) and the same ``validate_trace`` findings. Then an overload stream
on the CPU with the recorder on: one track per lane that ran plus the
dispatcher, scheduler and page-pool tracks, a trace that validates, a
``.prom`` text that parses line by line, and shed / cancel / fault counters
equal to the report's robustness block. Tolerance: exact.
"""

from __future__ import annotations

import io
import json
from collections import Counter

import pytest

from repro_torch.core import faults as tfaults
from repro_torch.core import telemetry as ttel
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime import serve as tserve
from repro_torch.runtime import tracing as ttrace
from test_torch_continuous import StepClock
from test_torch_faults import jaxpkg, tparams  # noqa: F401 (fixtures)
from test_torch_overload import _tengine, _traffic
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def pkgs():
    pytest.importorskip("jax")
    from repro.core import telemetry as jtel
    from repro.runtime import tracing as jtrace

    return {"jax": (jtel, jtrace), "port": (ttel, ttrace)}


def _fill(reg) -> None:
    reg.inc("lane_calls_total", lane="cbp")
    reg.inc("lane_calls_total", 3, lane="pf")
    reg.inc("admission_shed_total", 2.5, reason='we"ird\\label')
    reg.set("degrade_rung", 2)
    reg.set("pool_occupancy", 0.375, shard="0")
    for v in (0.01, 0.3, 4.0, 4.0, 70.0, 20000.0):
        reg.observe("lane_step_ms", v, lane="cbp")
    reg.histogram("ttft_ms", bounds=(1.0, 10.0)).observe(3.0)


def test_registry_prometheus_and_snapshot_equal_jax(pkgs):
    out = {}
    for name, (tel, _) in pkgs.items():
        reg = tel.MetricsRegistry()
        _fill(reg)
        first = (reg.to_prometheus(), reg.snapshot(),
                 reg.value("degrade_rung"), reg.value("nope", -1.0),
                 reg.value("lane_calls_total", lane="pf"),
                 reg.value("lane_calls_total", 7.0, lane="vf"))
        reg.rollover("warmup")
        reg.inc("lane_calls_total", lane="cbp")
        out[name] = first + (reg.to_prometheus(), reg.snapshot())
    assert out["port"] == out["jax"]
    text = out["port"][0]
    parsed = ttrace.parse_prometheus(text)
    assert parsed["types"] == {
        "admission_shed_total": "counter", "degrade_rung": "gauge",
        "lane_calls_total": "counter", "lane_step_ms": "histogram",
        "pool_occupancy": "gauge", "ttft_ms": "histogram"}
    assert 'lane_step_ms_bucket{lane="cbp",le="+Inf"} 6' in text
    assert 'reason="we\\"ird\\\\label"' in text


def test_recorder_ring_and_telemetry_switches_equal_jax(pkgs):
    out = {}
    for name, (tel, _) in pkgs.items():
        rec = tel.FlightRecorder(capacity=8, enabled=True)
        for i in range(20):
            rec.emit(f"e{i}", "scheduler" if i % 3 else "lane:cbp",
                     ts_ns=1000 + i)
        ring = (len(rec), rec.emitted, rec.dropped, rec.tracks(),
                [(e.name, e.ts_ns) for e in rec.events()])
        rec.clear()
        cleared = (len(rec), rec.emitted, rec.dropped, rec.events())
        t = tel.Telemetry()
        sw = [t.enabled, t.trace_or_none() is None]
        t.enable()
        sw += [t.enabled, t.trace_or_none() is t.recorder]
        t.disable()
        sw += [t.enabled]
        _fill(t.registry)
        out[name] = (ring, cleared, sw, t.metrics_json())
    assert out["port"] == out["jax"]
    assert out["port"][0][:3] == (8, 20, 12)
    assert json.loads(out["port"][3])["counters"]["lane_calls_total"]


def _events(rec) -> None:
    rec.emit("admit", "scheduler", ts_ns=5_000, args={"rid": 1})
    rec.emit("lane_step", "lane:cbp", ph="X", ts_ns=6_000, dur_ns=2_500)
    rec.emit("compile", "dispatcher", ph="X", ts_ns=4_000, dur_ns=900,
             args={"key": "('cbp', 4, 1, 'fp32')"})
    rec.emit("pool_occupancy", "page-pool", ph="C", ts_ns=7_000,
             args={"pages_in_use": 3, "pages_free": 17})
    rec.emit("lane_step", "lane:pf", ph="X", ts_ns=8_000, dur_ns=1_000)
    rec.emit("spec_rollback", "lane:vf", ts_ns=9_500,
             args={"slot": 0, "accepted": 1, "k": 2})


def test_chrome_trace_and_write_trace_equal_jax(pkgs, tmp_path):
    out = {}
    for name, (tel, trace) in pkgs.items():
        rec = tel.FlightRecorder(capacity=4, enabled=True)
        _events(rec)
        got = trace.chrome_trace(rec)
        buf = io.StringIO()
        written = trace.write_trace(buf, rec)
        path = tmp_path / f"{name}.json"
        trace.write_trace(str(path), rec)
        out[name] = (got, written, json.loads(buf.getvalue()),
                     json.loads(path.read_text()), trace.lane_track("dr"),
                     trace.validate_trace(got))
    assert out["port"] == out["jax"]
    got = out["port"][0]
    assert got["otherData"] == {"emitted": 6, "dropped": 2, "capacity": 4}
    names = {e["args"]["name"]: e["tid"] for e in got["traceEvents"]
             if e["name"] == "thread_name"}
    assert names["dispatcher"] == 1 and names["scheduler"] == 2
    assert names["page-pool"] == 3 and names["lane:pf"] >= 10
    assert out["port"][5] == []


BAD_TRACES = [
    {},
    {"traceEvents": []},
    {"traceEvents": [{"name": "x", "ph": "Q", "pid": 1, "tid": 1, "ts": 0}]},
    {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": 0}]},
    {"traceEvents": [{"ph": "i", "tid": 1}]},
    {"traceEvents": [{"name": "m", "ph": "M", "pid": 1, "tid": 0},
                     {"name": "c", "ph": "C", "pid": 1, "tid": 3}]},
]


@pytest.mark.parametrize("i", range(len(BAD_TRACES)))
def test_validate_trace_findings_equal_jax(pkgs, i):
    got = {name: trace.validate_trace(BAD_TRACES[i])
           for name, (_, trace) in pkgs.items()}
    assert got["port"] == got["jax"] and got["port"]


@pytest.mark.parametrize("text", [
    "lane_calls_total{lane=cbp} 3",  # unquoted label value
    "lane_calls_total 3 4",
    "# TYPE lane_calls_total summary",
    "# HELP lane_calls_total calls",
    "lane_step_ms_bucket{le=\"+Inf\"}",  # no value
])
def test_parse_prometheus_refuses_other_lines(text):
    good = '# TYPE lane_calls_total counter\nlane_calls_total{lane="cbp"} 3\n'
    assert ttrace.parse_prometheus(good) == {
        "types": {"lane_calls_total": "counter"}, "samples": 1}
    with pytest.raises(ValueError):
        ttrace.parse_prometheus(good + text)


def test_traced_overload_stream_exports(jaxpkg, tparams, tmp_path):  # noqa: F811
    """The recorder on through a hardened overload stream (drop-oldest
    queue, deadlines, the ladder with the int8 standby, a step_output and
    a pool_alloc fault): the trace validates and holds a track per lane
    that ran plus the dispatcher, scheduler and page-pool tracks; the
    Prometheus text parses; the registry's shed, cancel and fault counters
    and the report's robustness block both equal what the requests' fates
    and the plan count."""
    tel = ttel.Telemetry(enabled=True)
    eng = _tengine(tparams, tel, num_pages=16, kv_dtypes=("int8",))
    reqs = _traffic(tsched, jaxpkg["cfg"].vocab_size, n=20, rate=5000.0)
    for r in reqs[::4]:
        r.deadline_s = r.arrival_s + 0.1
    F = tfaults
    plan = F.FaultPlan([F.Fault(site="step_output", at=2),
                        F.Fault(site="pool_alloc", at=6)])
    try:
        rep = tserve.run_overload_stream(
            eng, reqs, slots=2, clock=StepClock(), capacity=8,
            shed_policy="drop-oldest", queue_ttl_s=0.5, degrade=True,
            faults=plan, watchdog=False,
        )
    finally:
        eng.close()
    path = tmp_path / "trace.json"
    trace = ttrace.write_trace(str(path), tel.recorder)
    assert ttrace.validate_trace(json.loads(path.read_text())) == []
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e["name"] == "thread_name"}
    lanes = {ttrace.lane_track(lane) for lane in rep["lane_calls"]}
    assert lanes and lanes | {"dispatcher", "scheduler", "page-pool"} <= tracks
    parsed = ttrace.parse_prometheus(tel.registry.to_prometheus())
    assert parsed["types"]["admission_shed_total"] == "counter"
    snap = json.loads(tel.metrics_json())
    rob = rep["robustness"]
    fr = plan.report()
    want = {
        "shed": Counter(r.shed_reason for r in reqs
                        if r.shed_reason and not r.cancelled),
        "cancelled": Counter(r.shed_reason for r in reqs if r.cancelled),
        "failed": Counter(r.error for r in reqs if r.error),
        "faults_injected": fr["injected"],
        "faults_detected": fr["detected"],
        "faults_contained": fr["contained"],
    }
    for key, family, label in (
            ("shed", "admission_shed_total", "reason"),
            ("cancelled", "requests_cancelled_total", "reason"),
            ("failed", "requests_failed_total", "site"),
            ("faults_injected", "faults_injected_total", "site"),
            ("faults_detected", "faults_detected_total", "site"),
            ("faults_contained", "faults_contained_total", "site")):
        got = {k: int(v) for k, v in
               tel.registry.labeled_values(family, label).items()}
        assert got == dict(want[key]) == rob.get(key, {}), key
    assert sum(want["shed"].values()) == rep["shed"] > 0
    assert sum(want["cancelled"].values()) == rep["cancelled"] > 0
    assert fr["injected"]["step_output"] == 1
    assert "faults_injected_total" in snap["counters"]
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"shed", "cancel", "quarantine", "fault_inject", "degrade",
            "alloc_failure"} <= names
