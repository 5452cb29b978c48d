"""The overload-hardened paged stream on a multi-device plan (DESIGN.md §15
on §16; ROADMAP A12 part 3, item 8): ``run_overload_stream`` with
``EngineConfig.mesh="1x2"`` against the JAX package on 4 fake devices (one
subprocess, C16's ``jax.make_mesh`` shim, as ``tests/test_torch_mesh.py``).

Olmo-1b smoke in fp32 (the JAX weights), ``tests/test_torch_overload.py``'s
engine (spec 2, a one-layer draft) at ``1x2``, under one step clock:

* inert (every knob at its default) = the port's ``run_paged_stream`` at
  ``1x2`` and the JAX package's ``run_overload_stream`` at ``1x2``, token
  for token, sync and async, a quarter sampled;
* hardened — 28 requests at 5000 req/s into 2 slots of a 16-page pool, a
  drop-oldest queue of 12 with a 0.5 s TTL, a quarter with deadlines, the
  ladder down to the int8 standby on the same plan (its pool, draft cache
  and targets the plan's, every rung a rebind over warm keys) and a
  ``FaultPlan`` over all five sites, without the wall-clock watchdog — the
  same rid fates, tokens, ladder transitions, fault report and robustness
  block as the JAX package's;
* the launcher's ``--engine overload --mesh 1x2 --meshes ""`` serves, with
  the JAX launcher's report keys.

Tolerance: exact.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.core import faults as tfaults
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime import serve as tserve
from test_torch_continuous import StepClock
from test_torch_faults import jaxpkg, tparams  # noqa: F401 (fixtures)
from test_torch_overload import ENGINE, SLOTS, _traffic
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = dict(mesh="1x2")
LAUNCH = ["--smoke", "--engine", "overload", "--degrade", "--chaos-seed",
          "7", "--requests", "8", "--mesh", "1x2", "--meshes", "", "--json"]


def flood(serve, sched, F, eng, vocab: int, StepClock) -> dict:
    """``tests/test_torch_overload.py``'s hardened run on ``eng``; what the
    two packages must agree on, JSON-shaped."""
    reqs = _traffic(sched, vocab, n=28, rate=5000.0)
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
    rep = serve.run_overload_stream(
        eng, reqs, slots=2, clock=StepClock(), capacity=12,
        shed_policy="drop-oldest", queue_ttl_s=0.5, degrade=True,
        faults=plan, watchdog=False,
    )
    return json.loads(json.dumps({
        "shed": sorted((r.rid, r.shed_reason) for r in reqs
                       if r.shed_reason and not r.cancelled),
        "cancelled": sorted(r.rid for r in reqs if r.cancelled),
        "failed": sorted(r.rid for r in reqs if r.error),
        "finished": sorted(r.rid for r in reqs if r.t_done is not None),
        "tokens": {r.rid: list(r.tokens) for r in reqs
                   if r.t_done is not None},
        "greedy": sorted(r.rid for r in reqs if r.greedy),
        "report": {k: rep[k] for k in (
            "degrade_transitions", "faults", "robustness", "shed",
            "cancelled", "failed", "unserved", "deadline_missed",
            "degrade_rung", "kv_dtype", "steps", "preemptions", "finished",
            "compiles_after_warmup")},
        "injected": plan.injected,
    }))


_SUBPROCESS = """
import jax
from jax.sharding import AxisType

_make_mesh = jax.make_mesh


def _auto_make_mesh(shape, axes, *a, **k):  # jax 0.9: Explicit by default
    k.setdefault("axis_types", (AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, *a, **k)


jax.make_mesh = _auto_make_mesh

from repro import models
from repro.configs import get_config
from repro.core import faults as F
from repro.core import reset_entry_points
from repro.launch import serve as jlaunch
from repro.runtime import scheduler as sched
from repro.runtime import serve

cfg = get_config('olmo-1b').smoke()
params = models.init_params(cfg, jax.random.PRNGKey(0))
out = {}
reset_entry_points()
eng = serve.Engine(cfg, params, serve.EngineConfig(**ENGINE, **MESH))
for async_steps in (False, True):
    reqs = _traffic(sched, cfg.vocab_size)
    rep = serve.run_overload_stream(eng, reqs, slots=SLOTS,
                                    clock=StepClock(),
                                    async_steps=async_steps)
    out[f'inert {async_steps}'] = dict(
        tokens=[list(r.tokens) for r in reqs], steps=rep['steps'],
        finished=rep['finished'])
eng.close()
reset_entry_points()
eng = serve.Engine(cfg, params, serve.EngineConfig(
    **{**ENGINE, 'num_pages': 16, 'kv_dtypes': ('int8',)}, **MESH))
out['flood'] = flood(serve, sched, F, eng, cfg.vocab_size, StepClock)
eng.close()
reset_entry_points()
out['launcher'] = sorted(jlaunch.main(LAUNCH)['overload'])
print('RESULT ' + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_runs():
    pytest.importorskip("jax")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=os.path.join(REPO, "src"),
    )
    code = "\n".join([
        "import json", f"ENGINE = {ENGINE!r}", f"SLOTS = {SLOTS!r}",
        f"MESH = {MESH!r}", f"LAUNCH = {LAUNCH!r}",
        inspect.getsource(_traffic), inspect.getsource(StepClock),
        inspect.getsource(flood), textwrap.dedent(_SUBPROCESS)])
    out = subprocess.run(
        [sys.executable, "-c", code], env=env,
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _engine(tparams, **over):  # noqa: F811
    from repro_torch.configs import get_config

    return tserve.Engine(get_config("olmo-1b").smoke(), tparams,
                         tserve.EngineConfig(**{**ENGINE, **over}, **MESH,
                                             devices=("cpu",) * 4),
                         device="cpu")


@pytest.fixture(scope="module")
def engine(tparams):  # noqa: F811
    with _engine(tparams) as eng:
        yield eng


@pytest.mark.parametrize("async_steps", [False, True])
def test_inert_overload_stream_on_a_plan_equals_jax(jax_runs, engine,
                                                    async_steps):
    vocab = engine.cfg.vocab_size
    a = _traffic(tsched, vocab)
    rep = tserve.run_overload_stream(engine, a, slots=SLOTS,
                                     clock=StepClock(),
                                     async_steps=async_steps)
    b = _traffic(tsched, vocab)
    prep = tserve.run_paged_stream(engine, b, slots=SLOTS, clock=StepClock(),
                                   async_steps=async_steps)
    toks = [list(r.tokens) for r in a]
    want = jax_runs[f"inert {async_steps}"]
    assert toks == [list(r.tokens) for r in b] == want["tokens"]
    assert rep["steps"] == prep["steps"] == want["steps"]
    assert rep["finished"] == len(a) == want["finished"]
    assert rep["lane_calls"] == prep["lane_calls"]
    for k in ("shed", "cancelled", "failed", "unserved",
              "compiles_after_warmup"):
        assert rep[k] == 0, k
    assert prep["mesh"] == "1x2" and any(not r.greedy for r in a)


def test_hardened_overload_stream_on_a_plan_equals_jax(jax_runs,
                                                       tparams):  # noqa: F811
    with _engine(tparams, num_pages=16, kv_dtypes=("int8",)) as eng:
        got = flood(tserve, tsched, tfaults, eng, eng.cfg.vocab_size,
                    StepClock)
        # the standby's pool is the plan's: a 1x2 pool of int8 pieces
        standby = eng.paged_cache("int8", "1x2")
        assert type(standby).__name__ == "ShardedCache"
    assert got == jax_runs["flood"]
    rep = got["report"]
    assert (rep["finished"] + rep["shed"] + rep["cancelled"] + rep["failed"]
            == 28) and rep["unserved"] == 0
    whys = [(t["to"], t["why"]) for t in rep["degrade_transitions"]]
    assert ("int8-pool", "overload") in whys
    assert set(rep["faults"]["injected"]) == set(tfaults.SITES)
    assert rep["compiles_after_warmup"] == 0


def test_launcher_overload_on_a_plan(jax_runs, capsys):
    from repro_torch.launch import serve as tlaunch

    rep = tlaunch.main(LAUNCH + ["--device", "cpu", "--devices",
                                 "cpu cpu cpu cpu"])
    capsys.readouterr()
    assert sorted(rep) == jax_runs["launcher"]
    assert rep["engine"] == "overload" and rep["unserved"] == 0
    assert rep["compiles_after_warmup"] == 0
