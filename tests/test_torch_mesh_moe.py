"""The MoE family on meshes of logical devices (ROADMAP A12 part 3 item 6,
part 1) against the JAX package on the same weights, requests and batches.

The JAX package runs in two subprocesses started with the module (each on
8 fake CPU devices, one thread, with the ``Auto``-axes shim of
``tests/test_torch_mesh.py`` in this test's code, ROADMAP C16) while the
port's own checks run: one serves (the int8 pool with speculation, the
smoke variant whose 3 experts ``model`` does not divide (TP on F) and the
split over mesh slices, then per MoE policy granite-moe smoke's paged and
dense streams at 1x2, then 2x1, then 2x2 on one engine each), the other
runs the mesh train steps and the dry run's records. The port runs on
``devices=("cpu",) * n``, one torch thread, on the JAX package's seeded
weights.

* Streams (``tests/test_torch_mesh.py``'s 6 requests, every other one
  sampled): the paged and the dense engine at 1x2, 2x1 and 2x2 under
  ``drop``, ``gather`` and ``dense``, the int8 pool with ``spec_k=2`` and
  an int8 draft at 2x2, the TP-on-F variant's paged stream at 2x2 and
  the split over mesh slices (decode 1x2, prefill 1x2@2) = the JAX
  package's tokens, 0 builds after warmup; the overload driver on a 1x2
  plan = ``run_paged_stream``; the capture report of a 1x2 ``cbp`` key:
  each MoE layer's ``all_reduce`` of a float32 ``[S, D]``, and its flops.
* One decode step's and one prefill chunk's logits per policy at 1x2 and
  2x2 within 1e-5 (fp32) of 1x1's, for the smoke config (EP) and the
  TP-on-F variant, and a ``vf``, ``cb``, ``pfd`` and ``vfd`` step's.
* The mesh train step: granite smoke with a 255-entry vocab (its tied
  table's ``d_model`` over ``("data", "model")``) at (2,2) and (1,2), and
  grok smoke at (pod, data, model) = (2,2,2) with ``zero_over_pod``: loss,
  ``moe_aux``, ``grad_norm`` and the params after one step = the JAX
  executable's within 1e-5; grok's moments sliced over ``pod``, its pod
  replicas bit for bit.
* ``fsdp``'s ``("data", "model")`` gather = the contiguous block, and
  ``reduce_grads`` its inverse.
* The dry run's granite and grok records on a (2,2) ``meta`` mesh = the JAX
  package's ``run_cell`` on a (2,2) mesh (keys, the analytic fields, flops
  exactly); jamba is still refused, naming ROADMAP A12 part 3.
* ``moe_hints`` and ``moe_weight_gather`` leave serving logits, the train
  step and the dry run's numbers as they are (the port's counterpart of
  ``test_moe_hints_preserve_semantics``), and their reader raises on a
  layout other than the one the flag asks for.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import subprocess
import sys
import textwrap
import time
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch import models, perf
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as tmoe
from repro_torch.models import tensor_parallel as tp
from repro_torch.optim import adamw
from repro_torch.runtime import steps
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.serve import (
    Engine,
    EngineConfig,
    run_overload_stream,
    run_paged_stream,
)
from test_torch_mesh import BASE, CPU4, REPO, stream
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

GRANITE = "granite-moe-1b-a400m"
POLICIES = ("drop", "gather", "dense")
LADDER = ("1x2", "2x1", "2x2")
ENGINES = ("paged", "dense")
INT8_SPEC = dict(kv_dtypes=("int8",), kv_dtype="int8", spec_k=2,
                 draft_kv_dtype="int8")
SHAPE = ShapeSpec("t", "train", 32, 8)
TRAIN_MESHES = {"granite 2x2": ((2, 2), ("data", "model")),
                "granite 1x2": ((1, 2), ("data", "model")),
                "grok 2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CELLS = {"t32": ("train", 32, 8), "p32": ("prefill", 32, 8),
         "d32": ("decode", 32, 8)}
DRY_ARCHS = (GRANITE, "grok-1-314b")
STATE_ATOL = 1e-5  # fp32: the same sums in another order
EXACT = ("chips", "tokens", "model_flops", "params_total", "params_active",
         "min_bytes_global")
# GSPMD splits the router's forward product [tokens, D] x [D, E] over
# 'model' in the decode and train programs (not in prefill); the port runs
# it whole on every model shard (ROADMAP C17)
ROUTER_SPLIT = {"t32": True, "p32": False, "d32": True}


def configs(get_config, replace) -> dict:
    """The compared configs, built alike in both packages: granite smoke,
    its 3-expert variant (TP on F at model 2), granite smoke with a
    255-entry vocab (its table's d_model over ("data", "model") at (2,2))
    and grok smoke."""
    g = get_config("granite-moe-1b-a400m").smoke()
    return {"granite": g, "tpf": replace(g, num_experts=3),
            "granite255": replace(g, vocab_size=255),
            "grok": get_config("grok-1-314b").smoke()}


def serve_ladder(cb, Request, vocab: int, meshes) -> dict:
    """One batcher serving a fresh stream at each mesh in turn (a rebind
    between two streams) -> {mesh: tokens}."""
    out, now = {}, 0.0
    for i, m in enumerate(meshes):
        if i:
            assert cb.set_mesh(m, now=now) == m
        rs = stream(Request, vocab)
        queue = list(rs)
        while queue or cb.has_work:
            n = cb.free_slots
            if queue and n:
                left = cb.admit(queue[:n], now=now)  # dense: the count seated
                left = queue[left:n] if isinstance(left, int) else list(left)
                queue = left + queue[n:]
            now += 0.1
            cb.step(now=now)
        out[m] = [list(r.tokens) for r in rs]
    return out


def batch_arrays(vocab: int) -> dict:
    """8 x 32 tokens; pads from token 5 in row 0 and all of row 6."""
    rng = np.random.default_rng(1)
    tok = rng.integers(0, vocab, (8, 32)).astype(np.int32)
    lab = tok.copy()
    lab[0, 5:] = -1
    lab[6, :] = -1
    return {"inputs": tok, "labels": lab}


_PRELUDE = """
import json
import sys
from dataclasses import replace

import jax
import numpy as np
from jax.sharding import AxisType

_make_mesh = jax.make_mesh


def _auto_make_mesh(shape, axes, *a, **k):  # jax 0.9: Explicit by default
    k.setdefault("axis_types", (AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, *a, **k)


jax.make_mesh = _auto_make_mesh
jax.devices()  # the 8 fake devices, before the dry run's 512 flag is set

from repro import models
from repro.configs import ShapeSpec, get_config
from repro.core import reset_entry_points
from repro.runtime.scheduler import Request
from repro.runtime.serve import (Engine, EngineConfig, run_continuous_stream,
                                 run_paged_stream)

CFGS = configs(get_config, replace)
OUT = sys.argv[1]
ALL = {}


def flat(tree):
    return {'.'.join(str(getattr(k, 'key', getattr(k, 'idx', k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def engine(cfg, **kw):
    reset_entry_points()
    return Engine(cfg, models.init_params(cfg, jax.random.PRNGKey(0)),
                  EngineConfig(**BASE, **kw))
"""

_SERVE = """
for kind in ENGINES:
    eng = engine(CFGS['granite'], moe_policy=JOB, mesh=LADDER[0],
                 meshes=LADDER[1:])
    cb = (eng.paged_continuous if kind == 'paged' else eng.continuous)(
        slots=4)
    for m, toks in serve_ladder(cb, Request, 256, LADDER).items():
        out[f'{kind} {m}'] = toks
    out[f'{kind} compiles'] = eng.post_warmup_compiles
    eng.close()
"""

_SPEC = """
import os

for name in ('granite', 'tpf'):  # the weights every serving job seeds
    np.savez(f'{OUT}/{name}.tmp.npz', **flat(models.init_params(
        CFGS[name], jax.random.PRNGKey(0))))
    os.replace(f'{OUT}/{name}.tmp.npz', f'{OUT}/{name}.npz')
eng = engine(CFGS['granite'], mesh='2x2', **INT8_SPEC)
rs = stream(Request, 256)
rep = run_paged_stream(eng, rs, slots=4)
out['int8 spec'] = dict(tokens=[list(r.tokens) for r in rs],
                        lane_steps=rep['lane_steps'],
                        compiles=rep['compiles_after_warmup'])
eng.close()
eng = engine(CFGS['tpf'], mesh='2x2')
rs = stream(Request, 256)
rep = run_paged_stream(eng, rs, slots=4)
out['tpf'] = dict(tokens=[list(r.tokens) for r in rs],
                  compiles=rep['compiles_after_warmup'])
eng.close()
eng = engine(CFGS['granite'], mesh='1x2', meshes=('1x2@2',))
cb = eng.paged_continuous(slots=4, disagg='1x2@2')
out['disagg'] = dict(
    tokens=serve_ladder(cb, Request, 256, ('1x2',))['1x2'],
    compiles=eng.post_warmup_compiles)
eng.close()
"""

_TRAIN = """
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.optim import adamw
from repro.runtime import steps

shape = ShapeSpec('t', 'train', 32, 8)
for name, ((dims, axes)) in TRAIN_MESHES.items():
    arch = name.split()[0]
    cfg = CFGS['granite255' if arch == 'granite' else arch]
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    np.savez(f'{OUT}/{arch}_params.npz', **flat(params))
    n = int(np.prod(dims))
    mesh = jax.make_mesh(dims, axes, devices=jax.devices()[:n])
    rows = ('pod', 'data') if 'pod' in axes else 'data'
    batch = {k: jax.device_put(v, NamedSharding(mesh, P(rows)))
             for k, v in batch_arrays(cfg.vocab_size).items()}
    state = steps.TrainState(params=params, opt=adamw.init(params))
    exe = steps.lower_for(cfg, mesh, shape, donate=False).compile()
    new, m = exe(steps.place_train_state(cfg, state, mesh), batch)
    out[name] = {k: float(v) for k, v in m.items()}
    np.savez(f"{OUT}/{name.replace(' ', '_')}_after.npz", **flat(new.params))
"""

_DRY = """
import repro.launch.dryrun as D

D.get_config = lambda arch: get_config(arch).smoke()
D.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (2, 2), ('data', 'model'), devices=jax.devices()[:4])
from repro.configs import SHAPES
for cell, (kind, seq, b) in CELLS.items():
    SHAPES[cell] = ShapeSpec(cell, kind, seq, b)
for arch in DRY_ARCHS:
    for cell in CELLS:
        out[f'dry {arch} {cell}'] = D.run_cell(arch, cell, 'single')
"""


BODIES = {"spec": _SPEC, "train": _TRAIN, "dry": _DRY}
# two processes, each running its jobs in turn ("spec" first: it writes
# the serving weights the port's streams load)
JOBS = {"serve": ("spec",) + POLICIES, "train": ("train", "dry")}


class _Jobs:
    """The JAX subprocesses, started together on first use; ``get(job)``
    waits for the one that runs ``job`` and returns the job's results."""

    def __init__(self, out_dir):
        env = dict(  # one thread each: they run beside the suite's workers
            os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
            XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                      "--xla_cpu_multi_thread_eigen=false "
                      "intra_op_parallelism_threads=1",
            PYTHONPATH=os.path.join(REPO, "src"),
        )
        head = "\n".join([
            "import numpy as np", f"BASE = {BASE!r}",
            f"ENGINES = {ENGINES!r}", f"LADDER = {LADDER!r}",
            f"INT8_SPEC = {INT8_SPEC!r}", f"TRAIN_MESHES = {TRAIN_MESHES!r}",
            f"CELLS = {CELLS!r}", f"DRY_ARCHS = {DRY_ARCHS!r}",
            inspect.getsource(configs), inspect.getsource(stream),
            inspect.getsource(serve_ladder), inspect.getsource(batch_arrays),
            textwrap.dedent(_PRELUDE)])
        self.out_dir = out_dir
        self.procs = {}
        for proc, jobs in JOBS.items():
            code = head + "".join(
                f"\nout = {{}}\nJOB = {job!r}\n"
                + textwrap.dedent(_SERVE if job in POLICIES else BODIES[job])
                + f"\nALL[{job!r}] = out\n" for job in jobs)
            self.procs[proc] = subprocess.Popen(
                [sys.executable, "-c",
                 code + "print('RESULT ' + json.dumps(ALL))\n",
                 str(out_dir)],
                env=env, cwd=REPO, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE)
        self.done: dict = {}

    def get(self, job: str) -> dict:
        proc = next(p for p, jobs in JOBS.items() if job in jobs)
        if proc not in self.done:
            stdout, stderr = self.procs[proc].communicate(timeout=900)
            assert self.procs[proc].returncode == 0, stderr[-3000:]
            line = next(x for x in stdout.splitlines()
                        if x.startswith("RESULT "))
            self.done[proc] = json.loads(line[len("RESULT "):])
        return self.done[proc][job]

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    if importlib.util.find_spec("jax") is None:
        pytest.skip("JAX is not installed")
    jobs = _Jobs(tmp_path_factory.mktemp("jax_mesh_moe"))
    yield jobs
    jobs.close()


@pytest.fixture(scope="module", autouse=True)
def _start_jax_runs(request):
    """Start the JAX jobs before the port's own checks, which run while
    they do (where JAX is missing, the tests that need them skip)."""
    try:
        request.getfixturevalue("jax_runs")
    except pytest.skip.Exception:
        pass


@pytest.fixture(scope="module")
def cfgs():
    return configs(get_config, replace)


def _params(jax_runs, arch: str) -> dict:
    """The JAX package's seeded weights of ``arch``, as the port's."""
    jax_runs.get("train")
    with np.load(jax_runs.out_dir / f"{arch}_params.npz") as z:
        return {k: torch.from_numpy(z[k].copy()) for k in z.files}


@pytest.fixture(scope="module")
def pparams(cfgs):
    """The port's own seeded weights of granite smoke and the TP-on-F
    variant (the checks that compare the port with itself)."""
    return {name: models.init_params(cfgs[name], seed=0)
            for name in ("granite", "tpf")}


@pytest.fixture(scope="module")
def jparams(jax_runs):
    """The JAX package's granite smoke and TP-on-F weights (every serving
    job seeds them alike; the ``spec`` job writes them first)."""
    out = {}
    for name in ("granite", "tpf"):
        path = jax_runs.out_dir / f"{name}.npz"
        while not path.exists():
            assert jax_runs.procs["serve"].poll() is None, jax_runs.get("spec")
            time.sleep(0.1)
        with np.load(path) as z:
            out[name] = {k: torch.from_numpy(z[k].copy()) for k in z.files}
    return out


def _engine(cfg, params, **kw) -> Engine:
    return Engine(cfg, params, EngineConfig(**BASE, devices=CPU4, **kw),
                  device="cpu")


# ------------------------------------------------------ the port alone
def test_capture_report_of_a_moe_key_counts_its_all_reduce(cfgs, pparams):
    """The 1x2 ``cbp`` key's all-reduce bytes: the vocab-parallel lookup,
    then per layer ``wo``'s and the MoE tail's, each a float32 ``[S, D]``
    (S = 4 slots, D = 64), a device's share."""
    from repro_torch.core.telemetry import Telemetry

    cfg = cfgs["granite"]
    with Engine(cfg, pparams["granite"],
                EngineConfig(**BASE, mesh="1x2", devices=CPU4),
                telemetry=Telemetry(compile_analysis=True),
                device="cpu") as eng:
        eng.paged_continuous(slots=4)
        reports = {r["key"]: r for r in eng.telemetry.compile_reports}
    rep = next(r for k, r in reports.items() if "'cbp'" in k)
    assert "error" not in rep and rep["chips"] == 2
    row = 4 * cfg.d_model * 4
    assert rep["collectives"]["all-reduce"] == (1 + 2 * cfg.num_layers) * row


# ---------------------------------------------------------- step logits
def _step_logits(cfg, params, policy: str, opts=None) -> dict:
    """One decode step and one prefill chunk on one pool content at 1x1,
    1x2 and 2x2 under ``policy`` -> each mesh's (decode, prefill) logits."""
    with _engine(cfg, params, moe_policy=policy,
                 meshes=("1x2", "2x2")) as eng:
        rng = np.random.default_rng(1)
        slots, pb = 4, 2
        pool1 = eng.paged_cache("fp32", "1x1")
        for t in (t for d in pool1 for t in d.values()):
            t.copy_(torch.from_numpy(rng.standard_normal(
                tuple(t.shape)).astype(np.float32)))
        blk = eng.pool_physical_pages // eng.pool_shards
        per_shard = slots // eng.pool_shards
        bt = torch.from_numpy(np.array(
            [[(s * eng.pool_shards // slots) * blk + 1 + (s % per_shard) * pb
              + j for j in range(pb)] for s in range(slots)], np.int32))
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (slots, 1),
                                            dtype=np.int32))
        pos = torch.tensor([3, 9, 12, 15], dtype=torch.int32)
        chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (slots, 5),
                                              dtype=np.int32))
        start = torch.tensor([0, 2, 8, 1], dtype=torch.int32)
        length = torch.tensor([5, 3, 4, 0], dtype=torch.int32)
        snap = [{n: t.clone() for n, t in d.items()} for d in pool1]
        out = {}
        with perf.use_perf_opts(opts or perf.PerfOpts()):
            for m in ("1x1", "1x2", "2x2"):
                pool = eng.paged_cache("fp32", m)
                models.relayout_cache(pool, snap)
                ps = eng._params_for_mesh(m)
                kw = dict(moe_policy=policy)
                if m == "1x1":
                    dec = models.paged_decode_step(cfg, ps, pool, tok, pos,
                                                   bt, **kw)[0]
                    models.relayout_cache(pool, snap)
                    pf = models.paged_prefill_step(cfg, ps, pool, chunk,
                                                   start, bt, length, **kw)[0]
                else:
                    lay = eng._layout(m, slots)
                    dec = tp.mesh_paged_decode_step(cfg, lay, ps, pool, tok,
                                                    pos, bt, **kw)
                    models.relayout_cache(pool, snap)
                    pf = tp.mesh_paged_prefill_step(cfg, lay, ps, pool, chunk,
                                                    start, bt, length, **kw)
                out[m] = (dec, pf)
    return out


@pytest.mark.parametrize("variant", ["granite", "tpf"])
@pytest.mark.parametrize("policy", POLICIES)
def test_one_step_logits_at_1x2_and_2x2_equal_1x1(cfgs, pparams, policy,
                                                  variant):
    """fp32 within 1e-5; under ``drop`` the 5-row chunk drops assignments
    (capacity 3 of 10 over 4 experts), the same ones on every shard."""
    out = _step_logits(cfgs[variant], pparams[variant], policy)
    for m in ("1x2", "2x2"):
        for got, want in zip(out[m], out["1x1"]):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("policy", POLICIES)
def test_lane_step_logits_equal_1x1(cfgs, pparams, policy):
    """The other lanes' steps (``vf`` over a pool, ``cb``, ``pfd`` and
    ``vfd`` over a dense cache; ``tests/test_torch_mesh_lanes.py``'s
    harness) at 1x2 and 2x2 within 1e-5 of 1x1's under ``policy``."""
    from test_torch_mesh_lanes import _lane_logits

    out = _lane_logits(cfgs["granite"], pparams["granite"], ("1x2", "2x2"),
                       moe_policy=policy)
    for m in ("1x2", "2x2"):
        for lane, got, want in zip(("vf", "cb", "pfd", "vfd"), out[m],
                                   out["1x1"]):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0,
                                       msg=f"{m} {lane}")


def test_drop_on_a_shard_drops_what_one_device_drops(cfgs, pparams):
    """The shards' partial outputs of one ``drop`` layer sum to one
    device's within 1e-6, where capacity 1 of a 12-token chunk drops most
    assignments (a shard that ranked only its own experts' assignments
    would keep some of them); each shard's part is zero on the rows routed
    to none of its experts."""
    cfg = replace(cfgs["granite"], capacity_factor=0.1)
    p = {k.split(".")[-1]: v[0] for k, v in pparams["granite"].items()
         if ".moe." in k}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))
    want, _ = tmoe.moe_apply(cfg, p, x, policy="drop", with_aux=False)
    parts = []
    for m in range(2):
        pm = {k: (v[2 * m:2 * m + 2] if k != "router" else v)
              for k, v in p.items()}
        y, idx, _ = tmoe.moe_shard(cfg, pm, x, policy="drop", lo=2 * m)
        mine = ((idx >= 2 * m) & (idx < 2 * m + 2)).any(-1)
        assert torch.all(y[~mine] == 0)
        parts.append(y)
    torch.testing.assert_close(parts[0] + parts[1], want, atol=1e-6, rtol=0)


# -------------------------------------------------------------- training
def _mesh(dims, axes, device="cpu"):
    return tmesh.make_debug_mesh(dims, axes,
                                 devices=[device] * int(np.prod(dims)))


def test_data_model_gather_is_the_contiguous_block():
    """A ``[6, 12]`` leaf split ``(None, ("data", "model"))`` on a 2x3 mesh:
    coordinate (d, m) holds chunk 3d + m, and ``gather_leaf`` gives it
    columns ``[4m, 4m + 4)``; ``reduce_grads`` of gradients in that layout
    gives each piece its chunk of their sum over the data rows."""
    mesh = _mesh((2, 3), ("data", "model"))
    spec = (None, ("data", "model"))
    whole = torch.arange(72, dtype=torch.float32).reshape(6, 12)
    pieces = shd.shard(whole, spec, mesh)
    assert torch.equal(pieces[(1, 0)], whole[:, 6:8])  # chunk 3, strided
    used = fsdp.gather_leaf(pieces, spec, mesh)
    for (d, m), t in used.items():
        assert torch.equal(t, whole[:, 4 * m:4 * m + 4]), (d, m)
    grads = {c: {"w": used[c] * (1 + c[0])} for c in mesh.coords()}
    got = fsdp.reduce_grads(grads, {"w": spec}, mesh)
    total = whole * 3  # rows 0 and 1 weighted 1 and 2
    for c in mesh.coords():
        want = total[shd.shard_slices(total.shape, spec, mesh, c)]
        assert torch.equal(got[c]["w"], want), c
    assert shd.spec_axes(fsdp.use_specs({"w": spec})["w"][1]) == ("model",)
    with pytest.raises(ValueError, match="does not divide"):
        coll.reduce_scatter({c: whole[:, :5] for c in mesh.coords()}, mesh,
                            "data", dim=1)


# --------------------------------------------------------------- dry run
@pytest.fixture
def small_cells(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch).smoke())
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: _mesh((2, 2),
                                                      ("data", "model"),
                                                      "meta"))
    from repro_torch.configs import SHAPES

    for name, (kind, seq, batch) in CELLS.items():
        monkeypatch.setitem(SHAPES, name, ShapeSpec(name, kind, seq, batch))


def test_ssm_and_hybrid_families_are_still_refused():
    mesh = _mesh((2, 2), ("data", "model"), "meta")
    for arch in ("mamba2-370m", "jamba-1.5-large-398b"):
        with pytest.raises(NotImplementedError, match="A12 part 3"):
            steps.lower_for(get_config(arch).smoke(), mesh, SHAPE)


# ------------------------------------------------------------ the flags
FLAGS = ("moe_hints", "moe_weight_gather")


@pytest.mark.parametrize("flag", FLAGS)
def test_moe_flag_leaves_outputs_unchanged(cfgs, pparams, small_cells,
                                           flag):
    """Serving logits at 1x2 and 2x2, the (2,2) train step's metrics and
    state and the dry run's numbers are the unflagged ones, bit for bit."""
    opts = perf.PerfOpts(**{flag: True})
    for policy in ("drop", "gather"):
        plain = _step_logits(cfgs["granite"], pparams["granite"], policy)
        flagged = _step_logits(cfgs["granite"], pparams["granite"], policy,
                               opts)
        for m in ("1x2", "2x2"):
            for a, b in zip(plain[m], flagged[m]):
                assert torch.equal(a, b)
    cfg = cfgs["granite"]
    params = models.init_params(cfg, seed=0)
    batch = {k: torch.from_numpy(v)
             for k, v in batch_arrays(cfg.vocab_size).items()}
    runs = []
    for o in (None, opts):
        mesh = _mesh((2, 2), ("data", "model"))
        state = steps.place_train_state(cfg, steps.TrainState(
            params=params, opt=adamw.init(params)), mesh)
        new, m = steps.lower_train(cfg, mesh, SHAPE, opts=o).compile()(
            state, batch)
        runs.append((fsdp.unshard_state(new), m))
    (s0, m0), (s1, m1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(s0.params[k], s1.params[k]) for k in params)
    # (the process's first counting run may count a one-time op: warm up)
    recs = [dryrun.run_cell(GRANITE, "t32", "single", opts=o)
            for o in (None, opts, None)]
    for k in ("flops_per_device", "bytes_per_device", "mem",
              "collective_bytes_per_device"):
        assert recs[1][k] == recs[2][k], k
    assert recs[1]["perf_opts"][flag] is True


@pytest.mark.parametrize("flag", FLAGS)
def test_moe_flag_reader_raises_on_another_layout(cfgs, flag):
    """The reader states the layout each flag asks for: experts over
    ``model`` where it divides E (``moe_hints``), expert weights whole over
    ``data`` at use (``moe_weight_gather``)."""
    cfg = cfgs["granite"]
    e, d, f = cfg.num_experts, cfg.d_model, cfg.expert_d_ff
    whole = {"w_gate": torch.zeros(e // 2, d, f)}
    with perf.use_perf_opts(perf.PerfOpts(**{flag: True})):
        tmoe.check_mesh_opts(cfg, whole, "experts", 2)
        with pytest.raises(ValueError, match=flag):
            if flag == "moe_hints":
                tmoe.check_mesh_opts(cfg, whole, "ffn", 2)
            else:
                tmoe.check_mesh_opts(cfg, {"w_gate": torch.zeros(
                    e // 2, d // 2, f)}, "experts", 2)
    tmoe.check_mesh_opts(cfg, whole, "ffn", 2)  # unflagged: nothing asked
    assert not hasattr(perf, "UNREAD")  # every field has its reader
    assert getattr(perf.from_flags(**{flag: True}), flag) is True


def test_capture_report_of_a_moe_key_counts_each_shard_s_experts(
        cfgs, pparams):
    """The 1x2 ``cbp`` report's flops = half the 1x1 key's (attention,
    head and experts split over the two model shards: each runs its own
    experts' buffer) plus half the router's, which runs whole on both."""
    from repro_torch.core.telemetry import Telemetry

    cfg = cfgs["granite"]
    flops = {}
    for m in ("1x1", "1x2"):
        with Engine(cfg, pparams["granite"],
                    EngineConfig(**BASE, mesh=m, devices=CPU4),
                    telemetry=Telemetry(compile_analysis=True),
                    device="cpu") as eng:
            eng.paged_continuous(slots=4)
            flops[m] = next(r["flops"] for r in eng.telemetry.compile_reports
                            if "'cbp'" in r["key"])
    router = 2 * 4 * cfg.d_model * cfg.num_experts * cfg.num_layers
    assert flops["1x2"] == (flops["1x1"] + router) / 2


# ------------------------------------- against the JAX package
@pytest.mark.parametrize("name", list(TRAIN_MESHES))
def test_train_step_equals_jax(jax_runs, cfgs, name):
    arch = name.split()[0]
    cfg = cfgs["granite255" if arch == "granite" else arch]
    params = _params(jax_runs, arch)
    want = jax_runs.get("train")[name]
    dims, axes = TRAIN_MESHES[name]
    mesh = _mesh(dims, axes)
    state = steps.place_train_state(cfg, steps.TrainState(
        params=params, opt=adamw.init(params)), mesh)
    p_spec, mu_spec = state.specs
    batch = {k: torch.from_numpy(v)
             for k, v in batch_arrays(cfg.vocab_size).items()}
    new, m = steps.lower_for(cfg, mesh, SHAPE).compile()(state, batch)
    for k in ("loss", "moe_aux", "grad_norm", "ntok"):
        np.testing.assert_allclose(float(m[k]), want[k], rtol=0,
                                   atol=STATE_ATOL, err_msg=k)
    assert float(m["moe_aux"]) > 0
    got = fsdp.unshard_state(new).params
    with np.load(jax_runs.out_dir /
                 f"{name.replace(' ', '_')}_after.npz") as z:
        for k in params:
            np.testing.assert_allclose(got[k].numpy(), z[k], rtol=0,
                                       atol=STATE_ATOL, err_msg=k)
    if arch == "granite" and dims == (2, 2):
        assert p_spec["embed.embedding"] == (None, ("data", "model"))
    if arch == "grok":  # moments sliced over pod, replicas bit for bit
        zero = [k for k in p_spec if fsdp.zero_dim(p_spec[k], mu_spec[k])
                is not None]
        assert len(zero) == len(p_spec) - sum(
            fsdp._data_dim(s) is None for s in p_spec.values())
        for k in zero:
            z = fsdp.zero_dim(p_spec[k], mu_spec[k])
            for c in mesh.coords():
                assert (new.opt.mu[k][c].shape[z] * 2
                        == new.params[k][c].shape[z])
                twin = (1 - c[0],) + c[1:]
                assert torch.equal(new.params[k][c], new.params[k][twin]), k


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_dry_run_record_equals_jax(jax_runs, small_cells, arch, cell):
    want = jax_runs.get("dry")[f"dry {arch} {cell}"]
    got = dryrun.run_cell(arch, cell, "single")
    assert want["status"] == got["status"] == "ok"
    assert {k: sorted(v) if isinstance(v, dict) else None
            for k, v in got.items()} == {
        k: sorted(v) if isinstance(v, dict) else None
        for k, v in want.items()}
    for k in EXACT:
        assert got[k] == want[k], k
    cfg = get_config(arch).smoke()
    kind, seq, batch = CELLS[cell]
    tokens = batch // 2 * (1 if kind == "decode" else seq)  # a data row's
    half = cfg.num_layers * tokens * cfg.d_model * cfg.num_experts
    assert got["flops_per_device"] - want["flops_per_device"] == (
        half if ROUTER_SPLIT[cell] else 0)


@pytest.mark.parametrize("kind", ENGINES)
@pytest.mark.parametrize("policy", POLICIES)
def test_streams_at_each_mesh_equal_jax(jax_runs, cfgs, jparams, policy,
                                        kind):
    with _engine(cfgs["granite"], jparams["granite"], moe_policy=policy,
                 mesh=LADDER[0], meshes=LADDER[1:]) as eng:
        cb = (eng.paged_continuous if kind == "paged" else eng.continuous)(
            slots=4)
        got = serve_ladder(cb, Request, 256, LADDER)
        compiles = eng.post_warmup_compiles
        lay = {m: eng._layout(m, 4, paged=kind == "paged").moe
               for m in LADDER}
    want = jax_runs.get(policy)
    assert lay == dict.fromkeys(LADDER, "experts")
    for m in LADDER:
        assert got[m] == want[f"{kind} {m}"], m
    assert compiles == 0 == want[f"{kind} compiles"]


@pytest.mark.parametrize("arm", ["int8 spec", "tpf"])
def test_int8_spec_and_tp_on_f_streams_equal_jax(jax_runs, cfgs, jparams,
                                                 arm):
    kw = INT8_SPEC if arm == "int8 spec" else {}
    name = "granite" if arm == "int8 spec" else "tpf"
    with _engine(cfgs[name], jparams[name], mesh="2x2", **kw) as eng:
        rs = stream(Request, 256)
        rep = run_paged_stream(eng, rs, slots=4)
        moe = eng._layout("2x2", 4).moe
    want = jax_runs.get("spec")[arm]
    assert [list(r.tokens) for r in rs] == want["tokens"]
    assert rep["compiles_after_warmup"] == 0 == want["compiles"]
    assert moe == ("experts" if arm == "int8 spec" else "ffn")
    if arm == "int8 spec":
        assert rep["lane_steps"] == want["lane_steps"]
        assert rep["lane_steps"]["verify"] > 0 < rep["lane_steps"]["draft"]


def test_disagg_and_overload_on_mesh_plans(jax_runs, cfgs, jparams):
    """The split over mesh slices (decode 1x2, prefill 1x2@2) serves the
    JAX package's split stream, and the overload driver at its defaults on
    a 1x2 plan ``run_paged_stream``'s, with no build after warmup."""
    cfg, params = cfgs["granite"], jparams["granite"]
    with _engine(cfg, params, mesh="1x2") as eng:
        rs = stream(Request, 256)
        run_paged_stream(eng, rs, slots=4)
        shared = [list(r.tokens) for r in rs]
        rs = stream(Request, 256)
        rep = run_overload_stream(eng, rs, slots=4)
        assert [list(r.tokens) for r in rs] == shared
        assert rep["compiles_after_warmup"] == 0
    with _engine(cfg, params, mesh="1x2", meshes=("1x2@2",)) as eng:
        cb = eng.paged_continuous(slots=4, disagg="1x2@2")
        got = serve_ladder(cb, Request, 256, ("1x2",))["1x2"]
        assert cb.disagg and eng.post_warmup_compiles == 0
    want = jax_runs.get("spec")["disagg"]
    assert got == want["tokens"] and want["compiles"] == 0
