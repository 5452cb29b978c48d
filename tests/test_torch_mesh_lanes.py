"""Every lane of both continuous engines on meshes of more than one logical
device (DESIGN.md §16; ROADMAP A12 part 3, items 1-2) against the JAX
package on the same weights and requests.

The JAX package's streams run once, in one subprocess on 4 fake CPU
devices, with ``tests/test_torch_mesh.py``'s ``Auto``-axes shim for
``jax.make_mesh`` (ROADMAP C16) in this test's code. The port runs the same
streams on ``devices=("cpu",) * 4``: the olmo-1b smoke config in fp32,
``BASE`` of ``tests/test_torch_mesh.py`` (4 slots, page 8, chunked prefill
8), 6 requests (12-token prompts, 4 new tokens, every other one sampled),
one torch thread.

* The int8 paged stream with ``spec_k=2`` and an int8 draft, and the dense
  engine with ``spec_k=2``, at 1x1, 1x2 and 2x2: greedy and sampled tokens
  equal the JAX package's at the same mesh, the same lane steps and
  ``pool_shards``, 0 builds after warmup.
* Each engine's ladder arm (1x2, then 2x2 mid-stream, then 1x1) = the JAX
  run of the same arm: 2 rebinds, 0 builds.
* One K/V input (a one-layer model whose ``wk``/``wv`` select inputs,
  scaled per head, so every shard's K/V rows are the one-device rows bit
  for bit): the int8 pages and scales a ``pf`` chunk and a ``cbp`` step
  write at 1x2 and 2x2, and an int8 dense cache's rows after a ``drp``
  chunk and a ``dr`` step, equal 1x1's bit for bit once joined back. A
  shard-local absmax would give other scales.
* One ``vf``, ``cb``, ``pfd`` and ``vfd`` step's logits at 1x2 and 2x2
  within 1e-5 of 1x1's (fp32), and at 1x4 (2 kv heads over 4 shards: the
  dense cache's sequence split, the pool's kv heads whole) and, with one kv
  head, at 1x2 (the sequence split) and 1x3 (the dense cache whole).
* ``tests/test_torch_c13.py``'s two-batcher cases at 1x2 with speculation,
  through emulated graphs: the storage bank parks and claims sharded pools,
  dense and draft caches, and each batcher's tokens, steps and lane calls
  equal the same cases at 1x1.
* The launcher's ``--engine both`` and ``--kv-dtype int8 --spec-k`` on
  ``--mesh 1x2 --meshes "1x1 2x2"``.
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
from repro_torch.models import tensor_parallel as tp
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.serve import (
    Engine,
    EngineConfig,
    run_continuous_stream,
    run_paged_stream,
)
from test_torch_c13 import CASES, ENGINE as C13_ENGINE, _drive, _runs
from test_torch_faults import jaxpkg, tparams  # noqa: F401 (fixtures)
from test_torch_graphs import _emulated
from test_torch_mesh import BASE, CPU4, REPO, ladder, stream
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

MESHES = ("1x1", "1x2", "2x2")
ARMS = {
    "paged int8+spec": dict(kv_dtype="int8", spec_k=2, draft_kv_dtype="int8"),
    "dense chunked+spec": dict(spec_k=2),
}

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
from repro.runtime.serve import (Engine, EngineConfig, run_continuous_stream,
                                 run_paged_stream)

cfg = get_config('olmo-1b').smoke()
params = models.init_params(cfg, jax.random.PRNGKey(0))
out = {}
for arm, kw in ARMS.items():
    paged = arm.startswith('paged')
    for mesh in MESHES:
        reset_entry_points()
        eng = Engine(cfg, params, EngineConfig(mesh=mesh, **BASE, **kw))
        rs = stream(Request, cfg.vocab_size)
        run = run_paged_stream if paged else run_continuous_stream
        rep = run(eng, rs, slots=4)
        out[f'{arm} {mesh}'] = dict(
            tokens=[list(r.tokens) for r in rs],
            lane_steps=rep['lane_steps'],
            pool_shards=rep.get('pool_shards'),
            compiles=rep['compiles_after_warmup'])
        eng.close()
    reset_entry_points()
    eng = Engine(cfg, params, EngineConfig(mesh='1x2', meshes=('1x1', '2x2'),
                                           **BASE, **kw))
    cb = (eng.paged_continuous if paged else eng.continuous)(slots=4)
    rs = stream(Request, cfg.vocab_size)
    done = ladder(cb, rs)
    out[f'{arm} ladder'] = dict(
        tokens=[list(r.tokens) for r in rs], finished=len(done),
        compiles=eng.post_warmup_compiles,
        rebinds=int(eng.telemetry.registry.value('mesh_rebinds_total')))
    eng.close()
print('RESULT ' + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_lane_runs():
    """The JAX package's streams and ladders on 4 fake devices (one
    subprocess)."""
    pytest.importorskip("jax")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=os.path.join(REPO, "src"),
    )
    code = "\n".join([
        "import numpy as np", f"BASE = {BASE!r}", f"MESHES = {MESHES!r}",
        f"ARMS = {ARMS!r}", inspect.getsource(stream),
        inspect.getsource(ladder), textwrap.dedent(_SUBPROCESS)])
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
@pytest.mark.parametrize("arm", list(ARMS))
def test_stream_at_each_mesh_equals_jax(jax_lane_runs, cfg, tparams, arm,
                                        mesh):
    with _engine(cfg, tparams, mesh=mesh, devices=CPU4, **ARMS[arm]) as eng:
        rs = stream(Request, cfg.vocab_size)
        paged = arm.startswith("paged")
        rep = (run_paged_stream if paged else run_continuous_stream)(
            eng, rs, slots=4)
    want = jax_lane_runs[f"{arm} {mesh}"]
    assert [list(r.tokens) for r in rs] == want["tokens"]
    assert any(not r.greedy for r in rs)
    assert rep["lane_steps"] == want["lane_steps"]
    assert rep["lane_steps"]["verify"] > 0 and rep["lane_steps"]["draft"] > 0
    assert rep["compiles_after_warmup"] == 0 == want["compiles"]
    if paged:
        assert rep["pool_shards"] == want["pool_shards"]
    assert rep["mesh"] == mesh


@pytest.mark.parametrize("arm", list(ARMS))
def test_ladder_arm_equals_jax(jax_lane_runs, cfg, tparams, arm):
    """Every lane warmed at every mesh of the ladder; 1x2 -> 2x2 -> 1x1
    mid-stream are two rebinds and no build."""
    with _engine(cfg, tparams, mesh="1x2", meshes=("1x1", "2x2"),
                 devices=CPU4, **ARMS[arm]) as eng:
        paged = arm.startswith("paged")
        cb = (eng.paged_continuous if paged else eng.continuous)(slots=4)
        verify = ("vf", 4, 2, "int8") if paged else ("vfd", 4, 2)
        for m in MESHES:
            assert verify + (m,) in eng._decode, m
            assert ("dr", 4, 2, "int8" if paged else "fp32", m) in eng._decode
        rs = stream(Request, cfg.vocab_size)
        done = ladder(cb, rs)
        rebinds = eng.telemetry.registry.value("mesh_rebinds_total")
        compiles = eng.post_warmup_compiles
    want = jax_lane_runs[f"{arm} ladder"]
    assert len(done) == want["finished"] == 6
    assert [list(r.tokens) for r in rs] == want["tokens"]
    assert rebinds == want["rebinds"] == 2
    assert compiles == want["compiles"] == 0


# ------------------------------------------------------- int8 bit for bit
def _selecting(cfg):
    """One layer of the smoke config whose ``wk``/``wv`` pick one input
    coordinate each, scaled by a power of two per kv head (heads' absmax
    apart by 8x): every product is exact, so each shard's K/V rows are the
    one-device rows bit for bit."""
    cfg = replace(cfg, num_layers=1)
    params = models.init_params(cfg, seed=5)
    d, kh, dh = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    for name, shift, base in (("wk", 0, 8.0), ("wv", 7, 4.0)):
        w = torch.zeros(1, d, kh, dh)
        for h in range(kh):
            for j in range(dh):
                w[0, (h * dh + j + shift) % d, h, j] = base ** h
        params[f"blocks.0.attn.{name}"] = w
    return cfg, params


def _int8_writes(cfg, params, mesh: str) -> dict:
    """A ``pf`` chunk then a ``cbp`` step on an int8 pool, and a ``drp``
    chunk then a ``dr`` step on an int8 dense cache, at 1x1 and at
    ``mesh`` (one pool geometry: ``mesh``'s shards): each mesh's pool and
    dense cache joined back onto one device, and the pool's null pages
    (where padding rows land: page 0 at 1x1, each data row's own on a
    mesh)."""
    rng = np.random.default_rng(7)
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 6),
                                          dtype=np.int32))
    start = torch.tensor([0, 3, 9, 1], dtype=torch.int32)
    length = torch.tensor([6, 4, 2, 0], dtype=torch.int32)
    tok, pos = chunk[:, :1].contiguous(), start + length
    out = {}
    with _engine(cfg, params, mesh="1x1", meshes=(mesh,), devices=CPU4,
                 kv_dtype="int8") as eng:
        blk = eng.pool_physical_pages // eng.pool_shards
        per = 4 // eng.pool_shards
        bt = torch.tensor([[(s * eng.pool_shards // 4) * blk + 1
                            + (s % per) * 2 + j for j in range(2)]
                           for s in range(4)], dtype=torch.int32)
        for m in ("1x1", mesh):
            pool = eng.paged_cache("int8", m)
            dense = eng._new_dense_cache(cfg, 4, "int8", m)
            ps = eng._params_for_mesh(m)
            if m == "1x1":
                models.paged_prefill_step(cfg, ps, pool, chunk, start, bt,
                                          length)
                models.paged_decode_step(cfg, ps, pool, tok, pos, bt)
                models.chunked_decode_step(cfg, ps, dense, chunk, start,
                                           length)
                models.decode_step(cfg, ps, dense, tok, pos)
                out[m] = (pool, dense)
                continue
            lay, dlay = eng._layout(m, 4), eng._layout(m, 4, paged=False)
            tp.mesh_paged_prefill_step(cfg, lay, ps, pool, chunk, start, bt,
                                       length)
            tp.mesh_paged_decode_step(cfg, lay, ps, pool, tok, pos, bt)
            tp.mesh_slot_prefill_step(cfg, dlay, ps, dense, chunk, start,
                                      length)
            tp.mesh_slot_decode_step(cfg, dlay, ps, dense, tok, pos)
            one_pool = models.init_paged_cache(
                cfg, eng.pool_physical_pages, BASE["page_size"], "int8")
            one_dense = models.init_cache(cfg, 4, BASE["max_len"], "int8")
            models.relayout_cache(one_pool, pool)
            models.relayout_cache(one_dense, dense)
            out[m] = (one_pool, one_dense)
        nulls = {d * blk for d in range(eng.pool_shards)}
    return out, nulls


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_int8_writes_equal_one_device_bit_for_bit(cfg, mesh):
    sel_cfg, params = _selecting(cfg)
    out, nulls = _int8_writes(sel_cfg, params, mesh)
    for kind, got, want in zip(("pool", "dense"), out[mesh], out["1x1"]):
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for name in w:
                a, b = g[name], w[name]
                if kind == "pool":  # the shards' null pages take padding
                    live = [p for p in range(b.shape[1]) if p not in nulls]
                    a, b = a[:, live], b[:, live]
                assert torch.equal(a, b), (mesh, kind, name)
    pool, dense = out["1x1"]
    assert nulls == {0, 11} if mesh == "2x2" else {0}
    # the rows were written, with the whole row's scale: its largest value
    # lies in the second kv head (8x the first's weights)
    assert bool((pool[0]["k_scale"] > 0).any())
    assert bool((dense[0]["ks"] > 0).any())
    k = dense[0]["k"].float()
    heads = k.abs().amax(dim=-1)[..., :][dense[0]["ks"] > 0]  # [rows, KH]
    assert bool((heads[:, 1] >= heads[:, 0]).all())
    assert bool((heads[:, 1] == 127).all())


# ----------------------------------------------------- one step's logits
def _lane_logits(cfg, params, meshes, moe_policy: str = "drop") -> dict:
    """One ``vf`` window (3 rows) over a pool and one ``cb`` step, ``pfd``
    chunk and ``vfd`` window over a dense cache, each from one content
    (random, laid out onto each mesh's pieces) at 1x1 and at ``meshes``
    (a MoE stack's tail under ``moe_policy``)."""
    rng = np.random.default_rng(3)
    out = {}
    with _engine(cfg, params, mesh="1x1", meshes=meshes,
                 devices=CPU4) as eng:
        pool1, dense1 = eng.paged_cache("fp32", "1x1"), eng.dense_cache(4)
        for t in (t for c in (pool1, dense1) for d in c for t in d.values()):
            t.copy_(torch.from_numpy(rng.standard_normal(
                tuple(t.shape)).astype(np.float32)))
        psnap = [{n: t.clone() for n, t in d.items()} for d in pool1]
        dsnap = [{n: t.clone() for n, t in d.items()} for d in dense1]
        blk = eng.pool_physical_pages // eng.pool_shards
        per = 4 // eng.pool_shards
        bt = torch.tensor([[(s * eng.pool_shards // 4) * blk + 1
                            + (s % per) * 2 + j for j in range(2)]
                           for s in range(4)], dtype=torch.int32)
        win = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 3),
                                            dtype=np.int32))
        chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 5),
                                              dtype=np.int32))
        tok = win[:, :1].contiguous()
        pos = torch.tensor([3, 9, 31, 15], dtype=torch.int32)
        start = torch.tensor([0, 2, 14, 27], dtype=torch.int32)
        length = torch.tensor([3, 2, 3, 0], dtype=torch.int32)
        kw = dict(moe_policy=moe_policy)
        for m in ("1x1",) + tuple(meshes):
            pool, dense = eng.paged_cache("fp32", m), eng.dense_cache(4, m)
            ps = eng._params_for_mesh(m)
            models.relayout_cache(pool, psnap)
            if m == "1x1":
                steps = (
                    lambda: models.decode_step(cfg, ps, dense, tok, pos,
                                               **kw)[0],
                    lambda: models.chunked_decode_step(
                        cfg, ps, dense, chunk, start, length, **kw)[0],
                    lambda: models.chunked_verify_step(
                        cfg, ps, dense, win, start, length, **kw)[0])
                vf = models.paged_verify_step(cfg, ps, pool, win, start, bt,
                                              length, **kw)[0]
            else:
                lay, dlay = eng._layout(m, 4), eng._layout(m, 4, paged=False)
                steps = (
                    lambda: tp.mesh_slot_decode_step(cfg, dlay, ps, dense,
                                                     tok, pos, **kw),
                    lambda: tp.mesh_slot_prefill_step(
                        cfg, dlay, ps, dense, chunk, start, length, **kw),
                    lambda: tp.mesh_slot_verify_step(
                        cfg, dlay, ps, dense, win, start, length, **kw))
                vf = tp.mesh_paged_verify_step(cfg, lay, ps, pool, win, start,
                                               bt, length, **kw)
            got = [vf]
            for step in steps:
                models.relayout_cache(dense, dsnap)
                got.append(step())
            out[m] = got
            if m != "1x1":
                out[m, "seq_split"] = dense.seq_split
    return out


@pytest.mark.parametrize("variant,meshes,seq_split", [
    ("smoke", ("1x2", "2x2"), (False, False)),
    ("smoke", ("1x4",), (True,)),
    ("kv-whole", ("1x2", "1x3"), (True, False)),
], ids=["smoke", "seq-split", "kv-whole"])
def test_one_lane_step_logits_equal_1x1(cfg, tparams, variant, meshes,
                                        seq_split):
    """fp32 within 1e-5: the smoke config (heads and kv heads split at mp
    2); at mp 4 its 2 kv heads stay whole (the pool replicated, the dense
    cache's sequence split over 4); one kv head at mp 2 (the sequence
    split) and mp 3 (32 positions do not divide: the dense cache whole)."""
    if variant == "smoke":
        params = tparams
    else:
        cfg = replace(cfg, num_kv_heads=1)
        params = models.init_params(cfg, seed=3)
    out = _lane_logits(cfg, params, meshes)
    assert tuple(out[m, "seq_split"] for m in meshes) == seq_split
    for m in meshes:
        for lane, got, want in zip(("vf", "cb", "pfd", "vfd"), out[m],
                                   out["1x1"]):
            assert got.shape == want.shape, (m, lane)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0,
                                       msg=f"{m} {lane}")


# ------------------------------------------------ the storage bank (C13)
@pytest.mark.parametrize("case", list(CASES))
def test_second_batcher_on_a_mesh_equals_1x1(cfg, tparams, monkeypatch,
                                             case):
    """``tests/test_torch_c13.py``'s cases with speculation on (so each
    batcher also holds a draft cache) through emulated graphs: at 1x2 the
    bank parks and claims the sharded pools, dense and draft caches, and
    every batcher's tokens, steps and lane calls equal 1x1's."""
    out = {}
    for mesh in ("1x1", "1x2"):
        with Engine(cfg, tparams, EngineConfig(
                **C13_ENGINE, spec_k=2, mesh=mesh, devices=CPU4),
                device="cpu") as eng:
            _emulated(monkeypatch, eng)
            out[mesh] = _drive(eng, _runs(tsched, cfg.vocab_size, case))
            assert eng.post_warmup_compiles == 0
            if mesh == "1x2":
                kinds = {type(b.cache).__name__ for b in eng._banks.values()}
                assert kinds == {"ShardedCache"}
    assert out["1x2"] == out["1x1"]
    assert any(c.get("vf") or c.get("vfd") for _, _, c in out["1x1"])


# --------------------------------------------------------------- launcher
@pytest.mark.parametrize("flags", [
    ["--engine", "both"],
    ["--engine", "continuous", "--spec-k", "2", "--prompt-len", "12"],
    ["--engine", "paged", "--kv-dtype", "int8", "--spec-k", "2",
     "--draft-kv-dtype", "int8", "--prefix-len", "16"],
], ids=["both", "continuous+spec", "paged-int8+spec"])
def test_launcher_serves_every_lane_on_a_mesh(flags):
    """In process: the report of each engine on the mesh (the burst engine
    of ``--engine both`` runs beside it, on the engine's device)."""
    from repro_torch.launch import serve as launcher

    rep = launcher.main([
        "--smoke", "--device", "cpu", "--requests", "6", "--max-len", "64",
        "--page-size", "8", "--prefill-chunk", "16", "--sample-frac", "0",
        "--mesh", "1x2", "--meshes", "1x1 2x2", "--devices",
        "cpu cpu cpu cpu", "--json", *flags])
    reps = rep if "burst" in rep else {flags[1]: rep}
    for name, r in reps.items():  # a burst engine builds the keys it meets
        assert r["finished"] == 6, name
        assert r["compiles_after_warmup"] == 0 or name == "burst", name
    served = reps.get("continuous", reps.get("paged"))
    assert served["mesh"] == "1x2"
    if "--spec-k" in flags:
        assert served["lane_steps"]["verify"] > 0
