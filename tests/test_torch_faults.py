"""Deterministic fault injection in the port (DESIGN.md §15) against the
JAX package (the twin of ``tests/test_faults.py``).

The host bookkeeping first, the same inputs through both packages:
``FaultPlan`` windows, ordinals, ``report`` and ``random(seed)``, the
validation errors, ``HeartbeatMonitor`` and ``StepTimeWatchdog`` over one
dt sequence. Then the batchers, port vs JAX, stepped with an explicit
``now`` per step (the JAX package's ``_drive``) on olmo-1b's smoke config
in fp32 with the JAX weights: the chaos matrix {dense, paged} x {sync,
async} x {spec on, off} under one ``step_output`` plan (finished rids and
tokens, failed rids, the plan's injected / detected / contained, the
batcher's fault counters), the retry limit failing the same victims, the
``build`` and ``pool_alloc`` faults (the same report, the same tokens),
and the ``d2h_stall`` ordinals: the port packs each commit boundary into
one pull and counts the JAX package's pulls, so one plan fires at the same
opportunities in both. Tolerance: exact (greedy fp32 streams, integer
counts).
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from repro_torch.core import faults as tfaults
from repro_torch.ft import failover as tfailover
from repro_torch.runtime.scheduler import Request as TRequest
from repro_torch.runtime.serve import Engine as TEngine
from repro_torch.runtime.serve import EngineConfig as TEngineConfig
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

ENGINE = dict(max_len=32, batch_quantum=2, max_batch=4, page_size=8,
              num_pages=20, prefill_chunk=8, spec_k=2, draft_layers=1)
SLOTS = 4


@pytest.fixture(scope="module")
def jaxpkg():
    """The JAX package's modules (skips where JAX is missing)."""
    jax = pytest.importorskip("jax")
    from repro import models as jm
    from repro.configs import get_config as jax_config
    from repro.core import faults as jfaults
    from repro.core import reset_entry_points
    from repro.ft import failover as jfailover
    from repro.runtime import scheduler as jsched
    from repro.runtime import serve as jserve

    cfg = jax_config("olmo-1b").smoke()
    params = jm.init_params(cfg, jax.random.PRNGKey(0))
    return dict(jax=jax, cfg=cfg, params=params, faults=jfaults,
                failover=jfailover, sched=jsched, serve=jserve,
                reset=reset_entry_points)


@pytest.fixture(scope="module")
def tparams(jaxpkg):
    from repro_torch.convert import params_from_jax

    jax = jaxpkg["jax"]
    return params_from_jax(jax.tree.map(np.asarray, jaxpkg["params"]))


@pytest.fixture(scope="module")
def engines(jaxpkg, tparams):
    """One engine per package for the whole module; every case takes a
    fresh batcher from it."""
    from repro_torch.configs import get_config

    jaxpkg["reset"]()
    jeng = jaxpkg["serve"].Engine(jaxpkg["cfg"], jaxpkg["params"],
                                  jaxpkg["serve"].EngineConfig(**ENGINE))
    teng = TEngine(get_config("olmo-1b").smoke(), tparams,
                   TEngineConfig(**ENGINE), device="cpu")
    yield {"jax": jeng, "port": teng}
    jeng.close()
    teng.close()


def _pkgs(jaxpkg) -> dict:
    return {
        "jax": (jaxpkg["faults"], jaxpkg["sched"].Request),
        "port": (tfaults, TRequest),
    }


def _reqs(Request, n=4, new_tokens=8, first=3):
    return [Request(rid=i, new_tokens=new_tokens, greedy=True,
                    first_token=first + i) for i in range(n)]


def _drive(cb, reqs, *, max_iters=600):
    """Step a batcher to completion, re-submitting preempted and
    quarantined (``requeued``) requests as the serving loops do (the JAX
    package's ``tests/test_faults.py::_drive``)."""
    pending = list(reqs)
    done = []
    it = 0
    while pending or cb.has_work:
        assert it < max_iters, "stream wedged"
        it += 1
        if pending:
            take, rest = pending[:cb.free_slots], pending[cb.free_slots:]
            out = cb.admit(take, now=float(it)) if take else []
            pending = (out if isinstance(out, list) else []) + rest
        done.extend(cb.step(now=float(it)))
        if getattr(cb, "preempted", None):
            pending.extend(cb.preempted)
            cb.preempted.clear()
        if cb.requeued:
            pending.extend(cb.requeued)
            cb.requeued.clear()
    done.extend(cb.flush(float(it + 1)))
    return done


def _batcher(eng, kind: str, async_steps: bool):
    if kind == "paged":
        return eng.paged_continuous(slots=SLOTS, async_steps=async_steps)
    return eng.continuous(slots=SLOTS, async_steps=async_steps)


def _outcome(cb, done, plan) -> dict:
    st = cb.stats
    return {
        "finished": sorted(r.rid for r in done),
        "tokens": {r.rid: list(r.tokens) for r in done},
        "failed": sorted(r.rid for r in cb.failed_requests),
        "errors": sorted((r.rid, r.error) for r in cb.failed_requests),
        "injected": list(plan.injected),
        "report": plan.report(),
        "stats": (st.faults_detected, st.faults_contained, st.faults_failed),
    }


# --------------------------------------------------------------- host units
def _plan_sites(plan) -> list:
    return sorted((f.site, f.at, f.slot, f.stall_s, f.span)
                  for fs in plan._by_site.values() for f in fs)


def test_fault_plan_windows_report_and_errors_equal_jax(jaxpkg):
    outs = {}
    for name, (F, _) in _pkgs(jaxpkg).items():
        plan = F.FaultPlan([F.Fault(site="step_output", at=2, span=2),
                            F.Fault(site="build", at=0),
                            F.Fault(site="step_output", at=3, slot=5)])
        hits = [plan.fire("build") is not None for _ in range(2)]
        fired = []
        for _ in range(6):
            f = plan.fire("step_output")
            fired.append(None if f is None else (f.at, f.slot, f.span))
        plan.note_detected("step_output")
        plan.note_contained("step_output")
        errs = []
        for bad in (lambda: F.Fault(site="gamma-ray", at=0),
                    lambda: F.Fault(site="build", at=-1),
                    lambda: F.Fault(site="build", at=0, span=0),
                    lambda: F.FaultPlan(["not a fault"]),
                    lambda: F.FaultPlan().fire("not-a-site")):
            with pytest.raises(F.FaultError) as e:
                bad()
            errs.append(str(e.value))
        outs[name] = (hits, fired, plan.injected, plan.report(),
                      plan.total_injected, plan.total_detected,
                      plan.total_contained, errs, F.SITES, F.POISON_TOKEN)
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == [None, None, (2, 0, 2), (2, 0, 2), None, None]


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_plans_equal_jax(jaxpkg, seed):
    jf = jaxpkg["faults"]
    for kw in ({}, {"sites": ("step_output", "d2h_stall"), "n": 9,
                    "horizon": 10, "stall_s": 0.5}):
        a = tfaults.FaultPlan.random(seed, **kw)
        b = jf.FaultPlan.random(seed, **kw)
        assert _plan_sites(a) == _plan_sites(b)
        assert a._opportunities == b._opportunities


def test_injected_fault_carries_its_fault(jaxpkg):
    f = tfaults.Fault(site="build", at=0)
    e = tfaults.InjectedFault(f)
    je = jaxpkg["faults"].InjectedFault(jaxpkg["faults"].Fault(site="build",
                                                               at=0))
    assert e.fault is f and str(e) == str(je)
    assert isinstance(e, RuntimeError)


def test_heartbeat_and_watchdog_equal_jax(jaxpkg):
    jfo = jaxpkg["failover"]
    outs = {}
    for name, fo in (("jax", jfo), ("port", tfailover)):
        mon = fo.HeartbeatMonitor(["a", "b"], timeout_s=2.0)
        beats = []
        for t in range(1, 9):
            mon.beat("a", t=float(t))
            if t < 3:
                mon.beat("b", t=float(t))
            beats.append(mon.failed(now=float(t)))
        wd = fo.StepTimeWatchdog(alpha=0.2, threshold=2.0, warmup=3)
        dts = [0.01, 0.012, 0.011, 0.05, 0.01, 0.013, 0.09, 0.2, 0.011]
        flags = [wd.observe(i, dt) for i, dt in enumerate(dts)]
        outs[name] = (beats, flags, wd.events, wd._ema)
    assert outs["port"] == outs["jax"]
    assert outs["port"][0][-1] == ["b"] and any(outs["port"][1])


def test_failover_plan_flips_on_heartbeat_loss():
    """The port's FailoverPlan over its Dispatcher: healthy until the
    monitor reports a failure, then one forced rebind to the degraded
    step (resharding the state first), exactly once."""
    from repro_torch.core import reset_entry_points

    reset_entry_points()
    seen = []
    plan = tfailover.FailoverPlan(
        healthy_fn=lambda x: x + 1, degraded_fn=lambda x: x - 1,
        reshard_fn=lambda s: s * 10, name="ft-test",
        on_failover=[seen.append],
    )
    mon = tfailover.HeartbeatMonitor(["w0", "w1"], timeout_s=1.0)
    mon.beat("w0", t=100.0)
    mon.beat("w1", t=100.0)
    assert plan.step(1) == 2 and not plan.degraded
    mon.beat("w0", t=1e12)
    state = plan.check(mon, 3)
    assert state == 30 and plan.degraded and plan.failovers == 1
    assert plan.step(1) == 0 and seen == [["w1"]]
    assert plan.check(mon, 4) == 4 and plan.failovers == 1
    plan.close()


# ------------------------------------------------------------ chaos matrix
MATRIX = list(itertools.product(("dense", "paged"), (False, True),
                                (True, False)))


@pytest.mark.parametrize("kind,async_steps,spec_on", MATRIX)
def test_chaos_matrix_equals_jax(jaxpkg, engines, kind, async_steps,
                                 spec_on):
    """The same ``step_output`` plan on the same stream: the same victims
    quarantined and retried, the same plan accounting and batcher
    counters, and every finished stream token for token the JAX
    package's — and free of poison."""
    outs = {}
    for name, (F, Request) in _pkgs(jaxpkg).items():
        cb = _batcher(engines[name], kind, async_steps)
        if not spec_on:
            assert cb.set_knobs(spec_k=0)["spec_k"] == 0
        plan = F.FaultPlan([F.Fault(site="step_output", at=2, slot=0),
                            F.Fault(site="step_output", at=5, slot=1)])
        cb.attach_faults(plan)
        done = _drive(cb, _reqs(Request, 4, new_tokens=8))
        outs[name] = _outcome(cb, done, plan)
    port = outs["port"]
    assert port == outs["jax"]
    inj = port["report"]["injected"]["step_output"]
    assert inj == 2 and port["report"]["detected"]["step_output"] == inj
    assert port["stats"][0] == inj
    assert port["report"]["contained"].get("step_output", 0) + \
        port["stats"][2] == inj
    assert all(t >= 0 for toks in port["tokens"].values() for t in toks)
    assert len(port["finished"]) == 4 - len(port["failed"])
    assert engines["port"].post_warmup_compiles == 0


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_retry_limit_fails_the_same_victims(jaxpkg, engines, kind):
    outs = {}
    for name, (F, Request) in _pkgs(jaxpkg).items():
        cb = _batcher(engines[name], kind, False)
        cb.set_knobs(spec_k=0)
        plan = F.FaultPlan([F.Fault(site="step_output", at=2, slot=0,
                                    span=3)])
        cb.attach_faults(plan)
        done = _drive(cb, _reqs(Request, 2, new_tokens=6))
        outs[name] = _outcome(cb, done, plan)
    assert outs["port"] == outs["jax"]
    assert outs["port"]["failed"] and all(
        e == "step_output" for _, e in outs["port"]["errors"])


def test_build_and_pool_alloc_faults_equal_jax(jaxpkg, tparams):
    """A build fault on a fresh engine's first cold build (detected,
    contained by the one-shot rebuild) and an allocation fault absorbed by
    the pool's evict/preempt/defer machinery: the same report and the same
    tokens in both packages."""
    from repro_torch.configs import get_config

    ecfg = dict(ENGINE, spec_k=0, prefill_chunk=0)
    outs = {}
    for name, (F, Request) in _pkgs(jaxpkg).items():
        if name == "jax":
            jaxpkg["reset"]()
            eng = jaxpkg["serve"].Engine(jaxpkg["cfg"], jaxpkg["params"],
                                         jaxpkg["serve"].EngineConfig(**ecfg))
        else:
            eng = TEngine(get_config("olmo-1b").smoke(), tparams,
                          TEngineConfig(**ecfg), device="cpu")
        plan = F.FaultPlan([F.Fault(site="build", at=0),
                            F.Fault(site="pool_alloc", at=2)])
        eng.attach_faults(plan)
        try:
            cb = eng.paged_continuous(slots=SLOTS)
            cb.attach_faults(plan)
            cb.pool.attach_faults(plan)
            done = _drive(cb, _reqs(Request, 4, new_tokens=8))
            outs[name] = (_outcome(cb, done, plan),
                          cb.pool.stats.alloc_failures,
                          eng.post_warmup_compiles)
        finally:
            eng.close()
    assert outs["port"] == outs["jax"]
    rep = outs["port"][0]["report"]
    assert rep["injected"] == {"build": 1, "pool_alloc": 1}
    assert rep["detected"] == {"build": 1, "pool_alloc": 1}
    assert rep["contained"] == {"build": 1}
    assert len(outs["port"][0]["finished"]) == 4 and outs["port"][2] == 0


STALL_ORDINALS = (0, 4, 5, 11, 17, 30)


@pytest.mark.parametrize("kind,async_steps,spec_on", [
    ("dense", False, False), ("dense", False, True), ("paged", False, True),
    ("paged", True, True), ("dense", True, False),
])
def test_d2h_stall_ordinals_equal_jax(jaxpkg, engines, kind, async_steps,
                                      spec_on):
    """The d2h_stall site counts the JAX package's pulls (three in a
    synchronous decode step, one per draft, verify, chunk and async
    commit): a plan armed over the dense path's ordinals fires at the same
    opportunities, with the same opportunity counts, beside a
    step_output fault. Zero-length stalls keep the wall clock out."""
    outs = {}
    for name, (F, Request) in _pkgs(jaxpkg).items():
        cb = _batcher(engines[name], kind, async_steps)
        if not spec_on:
            cb.set_knobs(spec_k=0)
        plan = F.FaultPlan([F.Fault(site="d2h_stall", at=a) for a in
                            STALL_ORDINALS]
                           + [F.Fault(site="step_output", at=3, slot=2)])
        cb.attach_faults(plan)
        done = _drive(cb, _reqs(Request, 4, new_tokens=10))
        outs[name] = (_outcome(cb, done, plan),
                      cb.stats.d2h_transfers if name == "port" else None)
    port, jax_ = outs["port"][0], outs["jax"][0]
    assert port == jax_
    opp = port["report"]["opportunities"]["d2h_stall"]
    assert port["report"]["injected"]["d2h_stall"] == sum(
        a < opp for a in STALL_ORDINALS) >= 4
    # one packed pull per synchronous decode step stands for three
    assert opp >= outs["port"][1]


def test_armed_empty_plan_is_inert(jaxpkg, engines):
    clean = _reqs(TRequest, 4, new_tokens=8)
    cb = engines["port"].paged_continuous(slots=SLOTS, seed=0)
    _drive(cb, clean)
    armed = _reqs(TRequest, 4, new_tokens=8)
    cb2 = engines["port"].paged_continuous(slots=SLOTS, seed=0)
    plan = tfaults.FaultPlan()
    engines["port"].attach_faults(plan)
    cb2.attach_faults(plan)
    cb2.pool.attach_faults(plan)
    cb2.attach_watchdog(tfailover.StepTimeWatchdog())
    try:
        _drive(cb2, armed)
    finally:
        engines["port"].attach_faults(None)
    assert [r.tokens for r in clean] == [r.tokens for r in armed]
    assert plan.total_injected == 0
    assert engines["port"].post_warmup_compiles == 0
