"""Paged serving on meshes of more than one logical device (DESIGN.md §16)
against the JAX package on the same weights and requests.

The JAX package's paged stream runs once, in one subprocess on 4 fake CPU
devices (``--xla_force_host_platform_device_count=4``). On jax 0.9
``jax.make_mesh`` gives ``Explicit`` axes, on which the package's own
``with_sharding_constraint`` refuses to run (ROADMAP C16); the subprocess
gives ``jax.make_mesh`` a default of ``Auto`` axes, a shim in this test's
code, not an edit to ``src/repro``. The port runs the same stream on
``devices=("cpu",) * 4``. The olmo-1b smoke config in fp32, 4 slots, page
8, chunked prefill 8, a stream of 6 requests (12-token prompts, 4 new
tokens, every other one sampled), one torch thread.

* At 1x1, 1x2, 2x1 and 2x2: greedy and sampled tokens equal the JAX
  package's at the same mesh, ``pool_shards`` equals its, 0 builds after
  warmup.
* The ladder arm of ``tests/test_sharding.py``: 1x2, then 2x2 mid-stream,
  then 1x1; tokens = the JAX run of the same arm, 2 rebinds, 0 builds.
* A 1x1 engine with a 2x1 standby (so a 2-shard pool) = the plain engine,
  bit for bit, and pool shards 2 and 1 as the JAX package's.
* One decode step's and one prefill chunk's logits at 1x2 and 2x2 within
  1e-5 of 1x1's on one pool content (and under layouts that leave the kv
  heads, the heads and the MLP whole, and split the table's d_model).
* The launcher's ``--mesh 1x2 --meshes "1x1 2x2"`` serves; the dense
  engine, speculation and int8 pools warm on a multi-device ladder
  (``tests/test_torch_mesh_lanes.py`` holds them to the JAX package), and
  so do disaggregation beside a multi-device plan and the capture report
  of a multi-device key; what still waits for ROADMAP A12 part 3 (an SSM
  stack) raises naming it; a plan across distinct devices raises.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import textwrap
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.models import tensor_parallel as tp
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.serve import Engine, EngineConfig, run_paged_stream
from test_torch_faults import jaxpkg, tparams  # noqa: F401 (fixtures)
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(max_len=32, batch_quantum=2, max_batch=4, page_size=8,
            num_pages=20, prefill_chunk=8)
CPU4 = ("cpu",) * 4
MESHES = ("1x1", "1x2", "2x1", "2x2")


def stream(Request, vocab: int, n: int = 6) -> list:
    """The compared stream: 12-token prompts, 4 new tokens, every other
    request sampled at temperature 0.8."""
    rng = np.random.default_rng(0)
    return [Request(rid=i, new_tokens=4, greedy=i % 2 == 0,
                    temperature=1.0 if i % 2 == 0 else 0.8, arrival_s=0.0,
                    prompt=tuple(int(x) for x in
                                 rng.integers(0, vocab, 12)))
            for i in range(n)]


def ladder(cb, reqs) -> list:
    """``tests/test_sharding.py``'s arm: serve at the active mesh, scale
    out to 2x2 mid-stream, shrink to 1x1."""
    done = []
    cb.admit(reqs[:2], now=0.0)
    for i in range(2):
        done += cb.step(now=0.1 * (i + 1))
    assert cb.set_mesh("2x2", now=0.3) == "2x2"
    cb.admit(reqs[2:4], now=0.3)
    for i in range(12):
        if not cb.has_work:
            break
        done += cb.step(now=0.4 + 0.1 * i)
    assert cb.set_mesh("1x1", now=2.0) == "1x1"
    cb.admit(reqs[4:], now=2.0)
    while cb.has_work:
        done += cb.step(now=3.0)
    return done


_SUBPROCESS = """
import json
import jax
from jax.sharding import AxisType

_make_mesh = jax.make_mesh


def _auto_make_mesh(shape, axes, *a, **k):  # jax 0.9: Explicit by default
    k.setdefault("axis_types", (AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, *a, **k)


jax.make_mesh = _auto_make_mesh

from repro import models
from repro.configs import get_config
from repro.core import reset_entry_points
from repro.runtime.scheduler import Request
from repro.runtime.serve import Engine, EngineConfig, run_paged_stream

cfg = get_config('olmo-1b').smoke()
params = models.init_params(cfg, jax.random.PRNGKey(0))
out = {}
for mesh in MESHES:
    reset_entry_points()
    eng = Engine(cfg, params, EngineConfig(mesh=mesh, **BASE))
    rs = stream(Request, cfg.vocab_size)
    rep = run_paged_stream(eng, rs, slots=4)
    out[mesh] = dict(tokens=[list(r.tokens) for r in rs],
                     pool_shards=rep['pool_shards'],
                     compiles=rep['compiles_after_warmup'])
    eng.close()
reset_entry_points()
eng = Engine(cfg, params, EngineConfig(mesh='1x2', meshes=('1x1', '2x2'),
                                       **BASE))
cb = eng.paged_continuous(slots=4)
rs = stream(Request, cfg.vocab_size)
done = ladder(cb, rs)
out['ladder'] = dict(
    tokens=[list(r.tokens) for r in rs], finished=len(done),
    shards=cb.pool.shards, compiles=eng.post_warmup_compiles,
    rebinds=int(eng.telemetry.registry.value('mesh_rebinds_total')))
eng.close()
reset_entry_points()
eng = Engine(cfg, params, EngineConfig(mesh='1x1', meshes=('2x1',), **BASE))
rs = stream(Request, cfg.vocab_size)
rep = run_paged_stream(eng, rs, slots=4)
out['standby'] = dict(tokens=[list(r.tokens) for r in rs],
                      pool_shards=rep['pool_shards'])
eng.close()
print('RESULT ' + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_mesh_runs():
    """The JAX package's streams on 4 fake devices (one subprocess)."""
    pytest.importorskip("jax")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=os.path.join(REPO, "src"),
    )
    code = "\n".join([
        "import numpy as np", f"BASE = {BASE!r}", f"MESHES = {MESHES!r}",
        inspect.getsource(stream), inspect.getsource(ladder),
        textwrap.dedent(_SUBPROCESS)])
    out = subprocess.run(
        [sys.executable, "-c", code], env=env,
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def cfg():
    return get_config("olmo-1b").smoke()


def _engine(cfg, params, **kw) -> Engine:
    return Engine(cfg, params, EngineConfig(**BASE, **kw), device="cpu")


@pytest.mark.parametrize("mesh", MESHES)
def test_stream_at_each_mesh_equals_jax(jax_mesh_runs, cfg, tparams, mesh):
    with _engine(cfg, tparams, mesh=mesh, devices=CPU4) as eng:
        rs = stream(Request, cfg.vocab_size)
        rep = run_paged_stream(eng, rs, slots=4)
    want = jax_mesh_runs[mesh]
    assert [list(r.tokens) for r in rs] == want["tokens"]
    assert any(not r.greedy for r in rs)
    assert rep["pool_shards"] == want["pool_shards"]
    assert rep["compiles_after_warmup"] == 0 == want["compiles"]


def test_ladder_arm_equals_jax(jax_mesh_runs, cfg, tparams):
    """Every paged lane warmed at every mesh of the ladder; 1x2 -> 2x2 ->
    1x1 mid-stream are two rebinds and no build."""
    with _engine(cfg, tparams, mesh="1x2", meshes=("1x1", "2x2"),
                 devices=CPU4) as eng:
        cb = eng.paged_continuous(slots=4)
        assert cb.mesh == "1x2" and cb.pool.shards == 2
        for m in ("1x1", "1x2", "2x2"):
            assert ("cbp", 4, 1, "fp32", m) in eng._decode, m
            assert ("pf", 4, 8, "fp32", m) in eng._decode, m
        rs = stream(Request, cfg.vocab_size)
        done = ladder(cb, rs)
        rebinds = eng.telemetry.registry.value("mesh_rebinds_total")
        compiles = eng.post_warmup_compiles
    want = jax_mesh_runs["ladder"]
    assert len(done) == want["finished"] == 6
    assert [list(r.tokens) for r in rs] == want["tokens"]
    assert rebinds == want["rebinds"] == 2
    assert compiles == want["compiles"] == 0
    assert want["shards"] == 2


def test_standby_2x1_leaves_1x1_bit_for_bit(jax_mesh_runs, cfg, tparams):
    streams, shards = {}, {}
    for tag, meshes in (("plain", ()), ("sharded", ("2x1",))):
        with _engine(cfg, tparams, mesh="1x1", meshes=meshes,
                     devices=("cpu", "cpu")) as eng:
            rs = stream(Request, cfg.vocab_size)
            rep = run_paged_stream(eng, rs, slots=4)
            streams[tag] = [list(r.tokens) for r in rs]
            shards[tag] = rep["pool_shards"]
    assert shards == {"plain": 1, "sharded": 2}
    assert jax_mesh_runs["standby"]["pool_shards"] == 2
    assert streams["sharded"] == streams["plain"]
    assert streams["sharded"] == jax_mesh_runs["standby"]["tokens"]


def _step_logits(cfg, params, meshes=("1x2", "2x2")) -> dict:
    """One prefill chunk and one decode step, on one pool content, at 1x1
    and at ``meshes``: the logits of each."""
    with _engine(cfg, params, mesh="1x1", meshes=meshes,
                 devices=CPU4) as eng:
        rng = np.random.default_rng(1)
        slots, pb = 4, 2
        pool1 = eng.paged_cache("fp32", "1x1")
        for t in (t for d in pool1 for t in d.values()):
            t.copy_(torch.from_numpy(rng.standard_normal(
                tuple(t.shape)).astype(np.float32)))
        # slot s's pages on its own shard's block (after its null page)
        blk = eng.pool_physical_pages // eng.pool_shards
        per_shard = slots // eng.pool_shards
        bt = np.array([[(s * eng.pool_shards // slots) * blk + 1
                        + (s % per_shard) * pb + j for j in range(pb)]
                       for s in range(slots)], np.int32)
        bt_t = torch.from_numpy(bt)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (slots, 1),
                                            dtype=np.int32))
        pos = torch.tensor([3, 9, 12, 15], dtype=torch.int32)
        chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (slots, 5),
                                              dtype=np.int32))
        start = torch.tensor([0, 2, 8, 1], dtype=torch.int32)
        length = torch.tensor([5, 3, 4, 0], dtype=torch.int32)
        snap = [{n: t.clone() for n, t in d.items()} for d in pool1]
        out = {}
        for m in ("1x1",) + tuple(meshes):
            pool = eng.paged_cache("fp32", m)
            models.relayout_cache(pool, snap)
            ps = eng._params_for_mesh(m)
            if m == "1x1":
                dec = models.paged_decode_step(cfg, ps, pool, tok, pos,
                                               bt_t)[0]
                models.relayout_cache(pool, snap)
                pf = models.paged_prefill_step(cfg, ps, pool, chunk, start,
                                               bt_t, length)[0]
            else:
                lay = eng._layout(m, slots)
                dec = tp.mesh_paged_decode_step(cfg, lay, ps, pool, tok,
                                                pos, bt_t)
                models.relayout_cache(pool, snap)
                pf = tp.mesh_paged_prefill_step(cfg, lay, ps, pool, chunk,
                                                start, bt_t, length)
            out[m] = (dec, pf)
    return out


@pytest.mark.parametrize("variant", ["smoke", "kv-whole", "heads-whole"])
def test_one_step_logits_at_1x2_and_2x2_equal_1x1(tparams, variant):
    """fp32 within 1e-5: the smoke config (heads, kv heads, d_ff, vocab all
    split at mp 2); one kv head (kv heads whole, query heads gathered);
    three heads, an odd d_ff and an odd vocab (attention and MLP whole,
    the table split over d_model)."""
    base = get_config("olmo-1b").smoke()
    if variant == "smoke":
        cfg, params = base, tparams
    else:
        cfg = (replace(base, num_kv_heads=1) if variant == "kv-whole"
               else replace(base, num_heads=3, num_kv_heads=1, d_ff=97,
                            vocab_size=255))
        params = models.init_params(cfg, seed=3)
    out = _step_logits(cfg, params)
    plan = shd.MeshPlan("1x2")
    specs = plan.param_specs(params)
    split = {k: shd.splits(specs[k], "model") for k in (
        "blocks.0.attn.wq", "blocks.0.attn.wk", "blocks.0.mlp.w_gate")}
    split["vocab"] = specs["embed.embedding"][0] == "model"
    assert split == {
        "smoke": dict.fromkeys(split, True),
        "kv-whole": {**dict.fromkeys(split, True), "blocks.0.attn.wk": False},
        "heads-whole": dict.fromkeys(split, False),
    }[variant]
    if variant == "heads-whole":  # the table's d_model splits instead
        assert specs["embed.embedding"] == (None, "model")
    for m in ("1x2", "2x2"):
        for got, want in zip(out[m], out["1x1"]):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_out_of_scope_lanes_raise_naming_part3(cfg, tparams):
    """The dense engine, speculation and int8 pools on a ladder with a
    multi-device plan serve (ROADMAP A12 part 3, items 1-2: every lane
    warmed at every mesh), and so does disaggregation beside a
    multi-device plan (item 3: the ``mg`` targets of every slice warmed;
    ``tests/test_torch_disagg_mesh.py`` holds its streams to the JAX
    package), with a capture report of every multi-device key (its
    collectives' bytes; ``tests/test_torch_capture_mesh.py``). What still
    waits for A12 part 3 is refused before anything is warmed, naming it:
    an SSM family, a plan across distinct devices."""
    served = [
        (dict(meshes=("1x2",)), "continuous", ("cb", 4, "1x2")),
        (dict(meshes=("1x2",), spec_k=2), "paged_continuous",
         ("vf", 4, 2, "fp32", "1x2")),
        (dict(meshes=("2x1",), kv_dtypes=("int8",)), "paged_continuous",
         ("cbp", 4, 1, "int8", "2x1")),
    ]
    for kw, make, key in served:
        with _engine(cfg, tparams, devices=CPU4, **kw) as eng:
            getattr(eng, make)(slots=4)
            assert key in eng._decode, key
            assert eng.post_warmup_compiles == 0
    with _engine(cfg, tparams, devices=CPU4,
                 meshes=("1x1@1", "1x2")) as eng:
        cb = eng.paged_continuous(slots=4, disagg="1x1@1")
        assert cb.disagg and eng.post_warmup_compiles == 0
        for m in ("1x1", "1x1@1", "1x2"):
            for op in ("gather", "scatter"):
                assert ("mg", op, "fp32", m) in eng._decode, (op, m)
    ssm = get_config("mamba2-370m").smoke()  # (MoE stacks are served)
    with Engine(ssm, models.init_params(ssm, seed=0),
                EngineConfig(**BASE, meshes=("1x2",), devices=CPU4),
                device="cpu") as eng:
        with pytest.raises(NotImplementedError, match="A12 part 3"):
            eng.continuous(slots=4)
    two = ("cpu", "cpu:1", "cpu", "cpu")  # two distinct logical devices
    with _engine(cfg, tparams, meshes=("1x2",), devices=two) as eng:
        with pytest.raises(NotImplementedError, match="distinct"):
            eng.paged_continuous(slots=4)
    from repro_torch.core.telemetry import Telemetry

    with Engine(cfg, tparams, EngineConfig(**BASE, mesh="1x2",
                                           devices=CPU4),
                telemetry=Telemetry(compile_analysis=True),
                device="cpu") as eng:
        eng.paged_continuous(slots=4)
        reports = eng.telemetry.compile_reports
    assert reports and not any("error" in r for r in reports)
    assert all(r["chips"] == 2 and r["collectives"]["all-reduce"] > 0
               for r in reports)


def test_launcher_serves_a_mesh(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
           "--device", "cpu", "--engine", "paged", "--requests", "6",
           "--max-len", "64", "--page-size", "8", "--prefix-len", "16",
           "--prefill-chunk", "16", "--mesh", "1x2", "--meshes", "1x1 2x2",
           "--devices", "cpu cpu cpu cpu", "--json"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rep = json.loads(out.stdout[out.stdout.index("{"):])
    assert rep["mesh"] == "1x2" and rep["pool_shards"] == 2
    assert rep["finished"] == 6 and rep["compiles_after_warmup"] == 0
