"""Overload hardening in the port (DESIGN.md §15) against the JAX package
(the twin of ``tests/test_overload.py``).

Host modules, the same inputs through both packages: ``AdmissionQueue``
(each shed policy, the queue TTL and its per-request override, the
invalid configs), ``DegradeController`` (one observation sequence: the
same rungs, transitions and dwell) and ``default_ladder``. The batchers on
olmo-1b's smoke config in fp32 with the JAX weights: ``set_knobs``
clamping into the warmed ranges, ``cancel`` and deadlines (dense and
paged, sync and async: the same cancelled rids, survivors' tokens and
pages in use), and the overload stream's pair — the first batcher and the
int8 standby on one engine — both speculating (the same tokens, drafted
and accepted counts and steps: each keeps its own draft state). The
stream: ``run_overload_stream`` with every knob at its
default equals the port's ``run_paged_stream`` and the JAX package's
``run_overload_stream`` token for token (sync and async, a quarter
sampled); hardened — a bounded drop-oldest queue with a TTL, deadlines,
the ladder down to the int8 standby and a ``FaultPlan`` over all five
sites, under one deterministic clock and without the wall-clock watchdog
— it sheds, cancels, fails and finishes the same rids with the same
tokens, ladder transitions, fault report and robustness block. Last the
launcher's ``--engine overload`` flags: the report's keys equal the JAX
launcher's, the trace validates and the ``.prom`` file parses.
Tolerance: exact.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from repro_torch.core import faults as tfaults
from repro_torch.core.telemetry import MetricsRegistry as TRegistry
from repro_torch.runtime import admission as tadm
from repro_torch.runtime import degrade as tdeg
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime import serve as tserve
from repro_torch.runtime.tracing import parse_prometheus, validate_trace
from test_torch_continuous import StepClock
from test_torch_faults import jaxpkg, tparams  # noqa: F401 (fixtures)
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

ENGINE = dict(max_len=32, batch_quantum=2, max_batch=4, page_size=8,
              num_pages=20, prefill_chunk=16, spec_k=2, draft_layers=1)
SLOTS = 4


@pytest.fixture(scope="module")
def host(jaxpkg):  # noqa: F811
    """(admission, degrade, Request, MetricsRegistry) per package."""
    from repro.core.telemetry import MetricsRegistry
    from repro.runtime import admission, degrade

    return {
        "jax": (admission, degrade, jaxpkg["sched"].Request,
                MetricsRegistry),
        "port": (tadm, tdeg, tsched.Request, TRegistry),
    }


def _tengine(tparams, telemetry=None, **over):  # noqa: F811
    from repro_torch.configs import get_config

    return tserve.Engine(get_config("olmo-1b").smoke(), tparams,
                         tserve.EngineConfig(**{**ENGINE, **over}),
                         telemetry=telemetry, device="cpu")


def _jengine(jaxpkg, **over):  # noqa: F811
    jaxpkg["reset"]()
    return jaxpkg["serve"].Engine(
        jaxpkg["cfg"], jaxpkg["params"],
        jaxpkg["serve"].EngineConfig(**{**ENGINE, **over}))


@pytest.fixture(scope="module")
def engines(jaxpkg, tparams):  # noqa: F811
    jeng, teng = _jengine(jaxpkg), _tengine(tparams)
    yield {"jax": jeng, "port": teng}
    jeng.close()
    teng.close()


# ----------------------------------------------------------- admission
def _q_run(adm, Request, Registry, policy, capacity, ttl=None,
           arrivals=(), pops=()) -> tuple:
    reg = Registry()
    q = adm.AdmissionQueue(capacity=capacity, shed_policy=policy,
                           queue_ttl_s=ttl, registry=reg)
    popped = []
    for a in arrivals:
        rid, t, prio, rttl = a
        q.submit(Request(rid=rid, new_tokens=4, first_token=3 + rid,
                         arrival_s=t, priority=prio, ttl_s=rttl))
    for now, limit in pops:
        popped.append([r.rid for r in q.pop_due(now, limit)])
    return (popped, [(r.rid, r.shed_reason) for r in q.shed], len(q),
            reg.labeled_values("admission_shed_total", "reason"))


ARRIVALS = [(0, 0.0, 1, None), (1, 0.5, 5, None), (2, 1.0, 3, 4.0),
            (3, 1.5, 2, None), (4, 2.0, 0, None), (5, 2.5, 7, 0.2),
            (6, 3.0, 1, None)]


@pytest.mark.parametrize("policy", ["reject-new", "drop-oldest",
                                    "priority"])
@pytest.mark.parametrize("capacity,ttl", [(None, None), (2, None), (3, 1.0),
                                          (None, 1.2)])
def test_admission_queue_equals_jax(host, policy, capacity, ttl):
    out = {
        name: _q_run(adm, Req, Reg, policy, capacity, ttl, ARRIVALS,
                     pops=((1.2, 1), (2.8, None), (9.0, 2), (9.0, None)))
        for name, (adm, _, Req, Reg) in host.items()
    }
    assert out["port"] == out["jax"]
    if capacity is None and ttl is None:  # only rid 5's own TTL sheds
        assert out["port"][1] == [(5, "ttl")]


def test_admission_invalid_configs_raise_alike(host):
    for adm, _, _, _ in host.values():
        assert adm.SHED_POLICIES == ("reject-new", "drop-oldest", "priority")
        for kw in (dict(capacity=0), dict(shed_policy="fifo"),
                   dict(queue_ttl_s=0.0), dict(queue_ttl_s=-1.0)):
            with pytest.raises(ValueError):
                adm.AdmissionQueue(**kw)


# ------------------------------------------------------------- ladder
@pytest.mark.parametrize("kw", [
    dict(spec_k=2, prefill_chunk=32, token_budget=64, int8_pool=True),
    dict(spec_k=0, prefill_chunk=8, token_budget=0),
    dict(spec_k=4, prefill_chunk=64, token_budget=72, min_chunk=16),
    dict(token_budget=1, int8_pool=True),
])
def test_default_ladder_equals_jax(host, kw):
    got = {name: [tuple(vars(r).values()) for r in deg.default_ladder(**kw)]
           for name, (_, deg, _, _) in host.items()}
    assert got["port"] == got["jax"]


OBS = ([dict(queue_depth=9)] * 2 + [dict(queue_depth=5)]
       + [dict(queue_depth=9)] * 3 + [dict(pool_frac=0.97)] * 3
       + [dict(queue_depth=0)] * 4 + [dict(straggler=True)] * 3
       + [dict(healthy=False)] * 2 + [dict(queue_depth=1)] * 7
       + [dict(p95_step_ms=50.0)] * 3 + [dict(p95_step_ms=1.0)] * 4)


def test_degrade_controller_equals_jax(host):
    out = {}
    for name, (_, deg, _, Reg) in host.items():
        reg = Reg()
        rungs = deg.default_ladder(spec_k=2, prefill_chunk=32,
                                   token_budget=64, int8_pool=True)
        c = deg.DegradeController(rungs, registry=reg, queue_high=8,
                                  queue_low=2, p95_high_ms=20.0,
                                  p95_low_ms=5.0, hysteresis=3)
        moves = []
        for i, o in enumerate(OBS):
            r = c.observe(0.25 * i, **o)
            moves.append(None if r is None else r.name)
        c.finalize(0.25 * len(OBS))
        out[name] = (moves, c.transitions, c.rung.name, reg.snapshot())
        with pytest.raises(ValueError):
            deg.DegradeController(())
        with pytest.raises(ValueError):
            deg.DegradeController(rungs, hysteresis=0)
    assert out["port"] == out["jax"]
    whys = {w for _, _, _, w in out["port"][1]}
    assert whys == {"overload", "recovered", "heartbeat"}


def test_apply_rung_and_set_knobs_equal_jax(host, engines):
    out = {}
    for name, (_, deg, _, _) in host.items():
        cb = engines[name].paged_continuous(slots=SLOTS)
        launch = dict(spec_k=cb.spec_k, prefill_chunk=cb.prefill_chunk,
                      token_budget=cb.token_budget)
        base = deg.Rung("base", **launch)
        got = [cb.set_knobs(spec_k=99, prefill_chunk=4096,
                            token_budget=10**6),
               cb.set_knobs(spec_k=-3, prefill_chunk=1, token_budget=0),
               cb.set_knobs(spec_k=1, prefill_chunk=9, token_budget=7),
               cb.set_knobs(prefill_chunk=12),
               deg.apply_rung(cb, deg.Rung("spec-off", spec_k=0), base),
               deg.apply_rung(cb, deg.Rung("x", prefill_chunk=8,
                                           token_budget=10), base),
               deg.apply_rung(cb, deg.Rung("healthy"), base),
               cb.set_knobs(**launch)]
        out[name] = (launch, got, engines[name].post_warmup_compiles)
    assert out["port"] == out["jax"]
    assert out["port"][1][0] == out["port"][0] == out["port"][1][-1]
    assert out["port"][2] == 0


# ---------------------------------------------------- cancel / deadlines
@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("async_steps", [False, True])
def test_cancel_and_deadlines_equal_jax(host, engines, kind, async_steps):
    """An explicit cancel of one seated request and a deadline on another,
    a third finishing inside the cancel's commit-then-discard window: the
    same cancelled rids and reasons, the survivors' tokens, the pages in
    use after (paged) — and a cancel of an unseated rid is refused."""
    out = {}
    for name, (_, _, Request, _) in host.items():
        eng = engines[name]
        cb = (eng.paged_continuous(slots=SLOTS, async_steps=async_steps)
              if kind == "paged"
              else eng.continuous(slots=SLOTS, async_steps=async_steps))
        cb.set_knobs(spec_k=0)
        reqs = [Request(rid=i, new_tokens=n, greedy=True, first_token=3 + i)
                for i, n in enumerate((8, 20, 3, 20))]
        reqs[3].deadline_s = 4.5
        cb.admit(reqs, now=0.0)
        for i in range(1, 4):
            cb.step(now=float(i))
        got = [cb.cancel(1, now=3.0), cb.cancel(1, now=3.0),
               cb.cancel(2, now=3.0), cb.cancel(77, now=3.0)]
        pages_mid = cb.pool.pages_in_use if kind == "paged" else None
        t = 4.0
        while cb.has_work:
            cb.step(now=t)
            t += 1.0
        cb.flush(t)
        st = cb.stats
        out[name] = (
            got, [(r.rid, r.shed_reason, r.cancelled)
                  for r in cb.cancelled_requests],
            {r.rid: r.tokens for r in reqs if r.done},
            (st.cancelled, st.deadline_missed, st.finished),
            pages_mid, cb.pool.pages_in_use if kind == "paged" else None,
            cb.free_slots,
        )
        if kind == "paged":
            cb.pool.check()
    assert out["port"] == out["jax"]
    assert out["port"][0][0] is True and out["port"][0][1] is False
    assert out["port"][1][-1][:2] == (3, "deadline")
    assert sorted(out["port"][2]) == [0, 2] or sorted(out["port"][2]) == [0]


# -------------------------------------------------------------- streams
def _traffic(sched, vocab: int, n: int = 10, rate: float = 400.0,
             sample_frac: float = 0.25) -> list:
    return sched.shared_prefix_arrivals(
        n, rate, seed=3, num_prefixes=2, prefix_len=12, tokens_mean=5.0,
        total_max=32, sample_frac=sample_frac, vocab=vocab,
    )


@pytest.mark.parametrize("async_steps", [False, True])
def test_inert_overload_stream_is_the_paged_stream(jaxpkg, engines,  # noqa: F811
                                                   async_steps):
    vocab = jaxpkg["cfg"].vocab_size
    a = _traffic(tsched, vocab)
    rep = tserve.run_overload_stream(engines["port"], a, slots=SLOTS,
                                     clock=StepClock(),
                                     async_steps=async_steps)
    b = _traffic(tsched, vocab)
    prep = tserve.run_paged_stream(engines["port"], b, slots=SLOTS,
                                   clock=StepClock(),
                                   async_steps=async_steps)
    j = _traffic(jaxpkg["sched"], vocab)
    jrep = jaxpkg["serve"].run_overload_stream(
        engines["jax"], j, slots=SLOTS, clock=StepClock(),
        async_steps=async_steps)
    toks = [r.tokens for r in a]
    assert toks == [r.tokens for r in b] == [r.tokens for r in j]
    assert rep["finished"] == prep["finished"] == len(a) == jrep["finished"]
    for k in ("shed", "cancelled", "failed", "unserved",
              "compiles_after_warmup"):
        assert rep[k] == jrep[k] == 0, k
    assert rep["degrade_transitions"] == [] and rep["faults"] is None
    assert rep["steps"] == prep["steps"] == jrep["steps"]
    assert rep["lane_calls"] == prep["lane_calls"]
    assert any(not r.greedy for r in a)


def _hardened(pkg: str, jaxpkg, tparams) -> tuple:  # noqa: F811
    """28 requests at 5000 req/s into 2 slots of a 16-page pool: a
    drop-oldest queue of 12 with a 0.5 s TTL, a quarter of the requests
    with a deadline, the ladder with the int8 standby, and a fault at each
    of the five sites, under one step clock."""
    over = dict(num_pages=16, kv_dtypes=("int8",))
    if pkg == "jax":
        sched, F, serve = jaxpkg["sched"], jaxpkg["faults"], jaxpkg["serve"]
        eng = _jengine(jaxpkg, **over)
    else:
        sched, F, serve = tsched, tfaults, tserve
        eng = _tengine(tparams, **over)
    reqs = _traffic(sched, jaxpkg["cfg"].vocab_size, n=28, rate=5000.0)
    for r in reqs[::4]:
        r.deadline_s = r.arrival_s + 0.1
    plan = F.FaultPlan([
        F.Fault(site="build", at=1),
        F.Fault(site="step_output", at=3), F.Fault(site="step_output", at=9,
                                                   slot=1),
        F.Fault(site="d2h_stall", at=20),
        F.Fault(site="pool_alloc", at=5), F.Fault(site="pool_alloc", at=40),
        F.Fault(site="heartbeat", at=30, span=3),
    ])
    try:
        rep = serve.run_overload_stream(
            eng, reqs, slots=2, clock=StepClock(), capacity=12,
            shed_policy="drop-oldest", queue_ttl_s=0.5, degrade=True,
            faults=plan, watchdog=False,
        )
    finally:
        eng.close()
    return reqs, rep, plan


@pytest.mark.parametrize("async_steps", [False, True])
def test_two_speculating_batchers_equal_jax(jaxpkg, tparams,  # noqa: F811
                                            async_steps):
    """The overload stream's pair — the model-dtype batcher and the int8
    standby on one engine, one slot count and one draft dtype — both
    speculating, stepped in turn: each keeps its own draft state, as each
    JAX batcher owns its draft cache, so the tokens, the drafted and
    accepted counts and the lane calls equal the JAX package's."""
    over = dict(kv_dtypes=("int8",), draft_layers=2)
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            sched, eng = jaxpkg["sched"], _jengine(jaxpkg, **over)
        else:
            sched, eng = tsched, _tengine(tparams, **over)
        reqs = _traffic(sched, jaxpkg["cfg"].vocab_size, n=8)
        try:
            pair = [eng.paged_continuous(slots=2, kv_dtype=dt,
                                         async_steps=async_steps)
                    for dt in (None, "int8")]
            pending = [reqs[0::2], reqs[1::2]]
            it = 0
            while any(pending) or any(b.has_work for b in pair):
                assert it < 400, "stream wedged"
                it += 1
                for b, todo in zip(pair, pending):
                    take = todo[:b.free_slots]
                    del todo[:len(take)]
                    if take:
                        todo[:0] = b.admit(take, now=float(it)) or []
                    b.step(now=float(it))
                    todo.extend(b.preempted)
                    b.preempted.clear()
            for b in pair:
                b.flush(float(it + 1))
        finally:
            eng.close()
        out[pkg] = ({r.rid: r.tokens for r in reqs},
                    [(b.stats.steps, b.stats.drafted_tokens,
                      b.stats.accepted_tokens, dict(b.stats.lane_calls))
                     for b in pair])
    assert out["port"] == out["jax"]
    assert all(len(t) == r.new_tokens for r, t in
               zip(reqs, out["port"][0].values()))
    assert all(n > 0 for _, n, _, _ in out["port"][1])


def test_hardened_overload_stream_equals_jax(jaxpkg, tparams):  # noqa: F811
    out = {}
    for pkg in ("jax", "port"):
        reqs, rep, plan = _hardened(pkg, jaxpkg, tparams)
        out[pkg] = {
            "shed": sorted((r.rid, r.shed_reason) for r in reqs
                           if r.shed_reason and not r.cancelled),
            "cancelled": sorted(r.rid for r in reqs if r.cancelled),
            "failed": sorted(r.rid for r in reqs if r.error),
            "finished": sorted(r.rid for r in reqs if r.t_done is not None),
            "greedy": {r.rid: r.tokens for r in reqs
                       if r.t_done is not None and r.greedy},
            "sampled": {r.rid: r.tokens for r in reqs
                        if r.t_done is not None and not r.greedy},
            "report": {k: rep[k] for k in (
                "degrade_transitions", "faults", "robustness", "shed",
                "cancelled", "failed", "unserved", "deadline_missed",
                "degrade_rung", "kv_dtype", "steps", "preemptions",
                "finished", "compiles_after_warmup")},
            "injected": plan.injected,
        }
    port = out["port"]
    assert port == out["jax"]
    rep = port["report"]
    assert (rep["finished"] + rep["shed"] + rep["cancelled"] + rep["failed"]
            == 28) and rep["unserved"] == 0
    assert rep["shed"] > 0 and rep["cancelled"] > 0
    whys = [(t["to"], t["why"]) for t in rep["degrade_transitions"]]
    assert ("int8-pool", "overload") in whys and ("healthy", "recovered") in whys
    assert set(rep["faults"]["injected"]) == set(tfaults.SITES)
    assert rep["compiles_after_warmup"] == 0
    for toks in port["greedy"].values():
        assert all(t >= 0 for t in toks)


# ------------------------------------------------------------ launcher
FLAGS = ["--smoke", "--engine", "overload", "--degrade", "--chaos-seed", "7",
         "--requests", "8", "--json"]


def test_launcher_overload_report_trace_and_metrics(jaxpkg, tmp_path,  # noqa: F811
                                                    capsys):
    from repro.launch import serve as jlaunch
    from repro_torch.launch import serve as tlaunch

    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    rep = tlaunch.main(FLAGS + ["--device", "cpu", "--trace-out", str(trace),
                                "--metrics-out", str(prom)])
    capsys.readouterr()
    jaxpkg["reset"]()
    jrep = jlaunch.main(FLAGS)["overload"]
    capsys.readouterr()
    assert sorted(rep) == sorted(jrep)
    assert rep["engine"] == "overload" and rep["unserved"] == 0
    assert rep["compiles_after_warmup"] == 0
    assert rep["faults"]["opportunities"]["step_output"] > 0
    t = json.loads(trace.read_text())
    assert validate_trace(t) == []
    tracks = {e["args"]["name"] for e in t["traceEvents"]
              if e["name"] == "thread_name"}
    assert {"dispatcher", "scheduler", "page-pool", "lane:cbp"} <= tracks
    parsed = parse_prometheus(prom.read_text())
    assert parsed["types"]["lane_calls_total"] == "counter"
    assert parsed["types"]["lane_step_ms"] == "histogram"
    assert parsed["samples"] > 10
    assert np.isfinite(rep["p50_ms"])
