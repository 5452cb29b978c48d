"""Disaggregated prefill/decode over slices that are meshes of more than one
logical device (DESIGN.md §17; ROADMAP A12 part 3, item 3), against the JAX
package on the same weights and requests.

The JAX package runs once, in one subprocess on 4 fake CPU devices, with
``jax.make_mesh`` given ``Auto`` axes there (ROADMAP C16, as
``tests/test_torch_mesh.py``). The port runs on ``devices=("cpu",) * 4``.
The olmo-1b smoke config in fp32 (the JAX weights), the reference's
``BASE`` config and ``mixed()`` stream (``tests/test_torch_disagg.py``),
one torch thread. Splits: decode ``"1x2"`` beside prefill ``"1x2@2"``
(``DisaggPlan.split("2x2")``: both slices split their heads over
``model``) and decode ``"2x1"`` beside ``"1x1@2"`` (``split("3x1")``: a
two-row pool beside a one-device pool holding both shards).

* Each split on fp32 and int8 pools, sync and async (``2x1`` on fp32,
  sync): greedy tokens, migrations, migrated pages, lane steps,
  ``pool_shards`` and builds after warmup = the JAX package's, and the
  tokens = the port's own shared stream on the same engine.
* split -> collapse -> split at ``1x2``: 2 ``disagg_rebinds``, 0 builds,
  tokens, migrations and lane steps = the JAX run of the same arm.
* A prompt repeated after its pages migrated hits the prefix trie, as in
  the JAX run.
* The stream through emulated graph targets = eager; the two slices'
  pools are distinct storage.
* The ``mg`` gather on a seeded pool at ``1x2``, ``2x1`` and ``2x2``, fp32
  and int8, = the JAX package's gather executable at the same mesh, bit for
  bit (the block is the global layout: heads in order, each page from the
  row that holds it, the int8 scales once); its scatter of a one-page
  migration, written into every layout, = the one-device scatter bit for
  bit, and leaves every other page of both pools as it was (the index's
  padding names the reserved null page, where a one-device pool's scatter
  writes the source's null page too).
* Page migration between pools of two shards conserves refcounts, and a
  migrated page lands in the destination table's shard.
* The launcher's ``--mesh 1x2 --meshes 1x2@2 --disagg`` serves, with the
  JAX launcher's report keys (but for the paged report's named
  differences, as on one device).

Tolerance: exact.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.runtime import kvcache, steps
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.serve import Engine, EngineConfig, run_paged_stream
from test_torch_disagg import BASE, _rebind_arm, mixed
from test_torch_faults import jaxpkg, tparams  # noqa: F401 (fixtures)
from test_torch_graphs import _emulated
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU4 = ("cpu",) * 4
# name: (decode mesh, prefill slice, pool dtype, async arms)
SPLITS = {
    "1x2 fp32": ("1x2", "1x2@2", "fp32", (False, True)),
    "1x2 int8": ("1x2", "1x2@2", "int8", (False, True)),
    "2x1 fp32": ("2x1", "1x1@2", "fp32", (False,)),
}
GATHER_MESHES = ("1x2", "2x1", "2x2")
PORT_KEYS = {"attn_impl", "cuda_graphs", "device", "mesh_rebinds"}
LAUNCH = ["--smoke", "--engine", "paged", "--requests", "4",
          "--prompt-len", "24", "--prefill-chunk", "8", "--max-len", "48",
          "--mesh", "1x2", "--meshes", "1x2@2", "--disagg", "--json"]


def pool_values(shapes: list, int8: bool, seed: int) -> list:
    """Seeded values for a pool of ``shapes`` ({leaf: shape} per period
    slot): int8 pages in [-127, 127], float32 everything else."""
    rng = np.random.default_rng(seed)
    out = []
    for layer in shapes:
        leaves = {}
        for n in sorted(layer):
            if int8 and n in ("k", "v"):
                leaves[n] = rng.integers(-127, 128, layer[n]).astype(np.int8)
            else:
                leaves[n] = rng.standard_normal(layer[n]).astype(np.float32)
        out.append(leaves)
    return out


def gather_index(block: int, pages: int) -> np.ndarray:
    """Live pages of both shard blocks of a two-shard pool, interleaved,
    then the null-page padding."""
    idx = np.zeros(pages, np.int32)
    idx[:4] = [3, block + 2, 7, block + 5]
    return idx


def pair(Request, vocab: int) -> list:
    """One prompt twice, the second after the first has finished."""
    prompt = tuple(int(x) for x in np.random.default_rng(7).integers(
        0, vocab, 24))
    return [Request(rid=i, new_tokens=4, greedy=True, arrival_s=5.0 * i,
                    prompt=prompt) for i in range(2)]


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
from repro.core import reset_entry_points
from repro.distributed import sharding as jshd
from repro.launch import serve as jlaunch
from repro.runtime.scheduler import Request
from repro.runtime.serve import Engine, EngineConfig, run_paged_stream

cfg = get_config('olmo-1b').smoke()
params = models.init_params(cfg, jax.random.PRNGKey(0))
out = {}
for name, (mesh, pf, dt, arms) in SPLITS.items():
    reset_entry_points()
    eng = Engine(cfg, params, EngineConfig(mesh=mesh, meshes=(pf,),
                                           kv_dtype=dt, **BASE))
    for async_steps in arms:
        rs = mixed(Request, cfg.vocab_size)
        rep = run_paged_stream(eng, rs, slots=4, disagg=pf,
                               async_steps=async_steps)
        out[f'{name} {async_steps}'] = dict(
            tokens=[list(r.tokens) for r in rs],
            migrations=rep['migrations'],
            migrated_pages=rep['migrated_pages'],
            lane_steps=rep['lane_steps'], pool_shards=rep['pool_shards'],
            compiles=rep['compiles_after_warmup'])
    if name == '1x2 fp32':
        r0 = int(eng.telemetry.registry.value('disagg_rebinds_total'))
        cb = eng.paged_continuous(slots=4, disagg=pf)
        rs = mixed(Request, cfg.vocab_size, seed=3)
        done = _rebind_arm(cb, rs)
        out['rebind'] = dict(
            finished=len(done), tokens=[list(r.tokens) for r in rs],
            rebinds=int(eng.telemetry.registry.value(
                'disagg_rebinds_total')) - r0,
            migrations=cb.stats.migrations,
            migrated_pages=cb.stats.migrated_pages,
            lane_steps=cb.stats.lane_steps,
            compiles=eng.post_warmup_compiles)
        ab = pair(Request, cfg.vocab_size)
        rep = run_paged_stream(eng, ab, slots=4, disagg=pf)
        out['trie'] = dict(tokens=[list(r.tokens) for r in ab],
                           shared=rep['shared_prompt_tokens'],
                           migrations=rep['migrations'])
    eng.close()
reset_entry_points()
eng = Engine(cfg, params, EngineConfig(mesh='2x2', meshes=('1x2', '2x1'),
                                       kv_dtypes=('int8',), **BASE))
blocks = {}
for dt in ('fp32', 'int8'):
    shape = jax.eval_shape(lambda: models.init_paged_cache(
        cfg, eng.pool_physical_pages, BASE['page_size'], dt))
    glob = pool_values([{n: x.shape for n, x in d.items()} for d in shape],
                       dt == 'int8', seed=5)
    idx = gather_index(eng.pool_physical_pages // eng.pool_shards,
                       eng.max_pages_per_req)
    for mesh in GATHER_MESHES:
        plan = eng._mesh_plan(mesh)
        cache = jax.device_put(glob, plan.paged_cache_shardings(shape))
        exe = eng._build_migrate('gather', dt, mesh)
        got = exe(cache, jax.device_put(idx, jshd.replicated(plan.mesh)))
        for i, d in enumerate(got):
            for n, x in d.items():
                blocks[f'{dt} {mesh} {i} {n}'] = np.asarray(x)
eng.close()
np.savez(BLOCKS, **blocks)
reset_entry_points()
rep = jlaunch.main(LAUNCH)
out['launcher'] = sorted(rep) if 'engine' in rep else sorted(
    next(iter(rep.values())))
print('RESULT ' + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's splits, arms, gathers and launcher on 4 fake
    devices (one subprocess); the gathered blocks in an ``.npz``."""
    pytest.importorskip("jax")
    blocks = tmp_path_factory.mktemp("blocks") / "jax_blocks.npz"
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=os.path.join(REPO, "src"),
    )
    code = "\n".join([
        "import json", "import numpy as np", f"BASE = {BASE!r}",
        f"SPLITS = {SPLITS!r}", f"GATHER_MESHES = {GATHER_MESHES!r}",
        f"LAUNCH = {LAUNCH!r}", f"BLOCKS = {str(blocks)!r}",
        inspect.getsource(mixed), inspect.getsource(_rebind_arm),
        inspect.getsource(pool_values), inspect.getsource(gather_index),
        inspect.getsource(pair), textwrap.dedent(_SUBPROCESS)])
    out = subprocess.run(
        [sys.executable, "-c", code], env=env,
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("RESULT "))
    res = json.loads(line[len("RESULT "):])
    with np.load(blocks) as f:
        res["blocks"] = {k: f[k] for k in f.files}
    return res


@pytest.fixture(scope="module")
def engines(tparams):  # noqa: F811
    """One port engine per split, every slice warmed."""
    cfg = get_config("olmo-1b").smoke()
    out = {name: Engine(cfg, tparams, EngineConfig(
        mesh=mesh, meshes=(pf,), kv_dtype=dt, devices=CPU4, **BASE),
        device="cpu") for name, (mesh, pf, dt, _) in SPLITS.items()}
    yield cfg, out
    for eng in out.values():
        eng.close()


@pytest.mark.parametrize("name,async_steps", [
    (name, a) for name, (_, _, _, arms) in SPLITS.items() for a in arms])
def test_split_stream_equals_jax_and_shared(jax_run, engines, name,
                                            async_steps):
    cfg, port = engines
    mesh, pf, dt, _ = SPLITS[name]
    eng = port[name]
    shared = mixed(Request, cfg.vocab_size)
    rep_s = run_paged_stream(eng, shared, slots=4, async_steps=async_steps)
    split = mixed(Request, cfg.vocab_size)
    rep = run_paged_stream(eng, split, slots=4, disagg=pf,
                           async_steps=async_steps)
    got = dict(tokens=[list(r.tokens) for r in split],
               migrations=rep["migrations"],
               migrated_pages=rep["migrated_pages"],
               lane_steps=rep["lane_steps"], pool_shards=rep["pool_shards"],
               compiles=rep["compiles_after_warmup"])
    assert got == jax_run[f"{name} {async_steps}"]
    assert got["tokens"] == [list(r.tokens) for r in shared]
    assert rep["disagg"] and rep["mesh"] == mesh
    assert rep["migrations"] == 5 and rep["migrated_pages"] == 1 + 4 * 3
    assert rep_s["compiles_after_warmup"] == got["compiles"] == 0
    assert rep["pool_shards"] == (2 if mesh == "2x1" else 1)


def test_split_collapse_split_equals_jax(jax_run, engines):
    cfg, port = engines
    mesh, pf, _, _ = SPLITS["1x2 fp32"]
    eng = port["1x2 fp32"]
    r0 = int(eng.telemetry.registry.value("disagg_rebinds_total"))
    cb = eng.paged_continuous(slots=4, disagg=pf)
    reqs = mixed(Request, cfg.vocab_size, seed=3)
    done = _rebind_arm(cb, reqs)
    got = dict(
        finished=len(done), tokens=[list(r.tokens) for r in reqs],
        rebinds=int(eng.telemetry.registry.value("disagg_rebinds_total"))
        - r0,
        migrations=cb.stats.migrations,
        migrated_pages=cb.stats.migrated_pages,
        lane_steps=cb.stats.lane_steps, compiles=eng.post_warmup_compiles)
    assert got == jax_run["rebind"]
    assert got["rebinds"] == 2 and got["compiles"] == 0


def test_prefix_trie_hit_after_a_migrated_fork(jax_run, engines):
    cfg, port = engines
    a, b = pair(Request, cfg.vocab_size)
    rep = run_paged_stream(port["1x2 fp32"], [a, b], slots=4,
                           disagg="1x2@2")
    assert rep["migrations"] > 0 and rep["shared_prompt_tokens"] >= 16
    assert a.tokens == b.tokens and rep["compiles_after_warmup"] == 0
    assert dict(tokens=[list(a.tokens), list(b.tokens)],
                shared=rep["shared_prompt_tokens"],
                migrations=rep["migrations"]) == jax_run["trie"]


@pytest.mark.parametrize("name", ["1x2 int8", "2x1 fp32"])
def test_split_through_emulated_graphs_equals_eager(engines, tparams,  # noqa: F811
                                                    monkeypatch, name):
    """Each slice's ``pf``, ``cbp`` and ``mg`` targets captured over its own
    pool (the mesh's pieces), static inputs written as a replay writes
    them: the tokens of the eager split."""
    cfg, port = engines
    mesh, pf, dt, _ = SPLITS[name]
    want = mixed(Request, cfg.vocab_size)
    run_paged_stream(port[name], want, slots=4, disagg=pf)
    with Engine(cfg, tparams, EngineConfig(
            mesh=mesh, meshes=(pf,), kv_dtype=dt, devices=CPU4, **BASE),
            device="cpu") as eng:
        _emulated(monkeypatch, eng)
        got = mixed(Request, cfg.vocab_size)
        rep = run_paged_stream(eng, got, slots=4, disagg=pf)
        pools = {id(t.graph.owned) for k, t in eng._decode.cache._table.items()
                 if k[0] in ("pf", "cbp", "mg")}
        dec, pre = eng.paged_cache(dt, mesh), eng.paged_cache(dt, pf)
        ptrs = [{t.data_ptr() for d in c for t in d.values()}
                for c in (dec, pre)]
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert rep["compiles_after_warmup"] == 0 and rep["migrations"] == 5
    assert len(pools) == 2 and not ptrs[0] & ptrs[1]


# ----------------------------------------------------------- the mg blocks
@pytest.fixture(scope="module")
def gather_engine(tparams):  # noqa: F811
    cfg = get_config("olmo-1b").smoke()
    with Engine(cfg, tparams, EngineConfig(
            mesh="2x2", meshes=("1x2", "2x1"), kv_dtypes=("int8",),
            devices=CPU4, **BASE), device="cpu") as eng:
        yield cfg, eng


def _global(eng, dt: str, seed: int) -> list:
    """A seeded global pool of the engine's geometry (``pool_values``)."""
    shapes = models.init_paged_cache(eng.cfg, eng.pool_physical_pages,
                                     BASE["page_size"], dt, device="meta")
    vals = pool_values([{n: tuple(t.shape) for n, t in d.items()}
                        for d in shapes], dt == "int8", seed)
    return [{n: torch.from_numpy(x) for n, x in d.items()} for d in vals]


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.uint32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("dt", ["fp32", "int8"])
@pytest.mark.parametrize("mesh", GATHER_MESHES)
def test_mg_gather_equals_the_jax_gather_bit_for_bit(jax_run, gather_engine,
                                                     dt, mesh):
    _, eng = gather_engine
    glob = _global(eng, dt, seed=5)
    pool = eng.paged_cache(dt, mesh)
    models.relayout_cache(pool, glob)
    idx = torch.from_numpy(gather_index(
        eng.pool_physical_pages // eng.pool_shards, eng.max_pages_per_req))
    block = steps.make_page_gather_fn()(None, pool, idx)
    leaves = steps.page_leaves(pool)
    assert len(block) == len(leaves) == (4 if dt == "int8" else 2)
    for (i, n), b in zip(leaves, block):
        want = jax_run["blocks"][f"{dt} {mesh} {i} {n}"]
        assert tuple(b.shape) == want.shape, (i, n)
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(want))
        one = glob[i][n][:, idx.long()]  # the one-device gather
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(one.numpy()))


@pytest.mark.parametrize("dt", ["fp32", "int8"])
@pytest.mark.parametrize("mesh", GATHER_MESHES)
def test_one_page_scatter_leaves_every_other_page(gather_engine, dt, mesh):
    """Source page 9 (row 0) migrates to page 26 (the second shard's
    block) of another pool of the same layout: the destination = the
    one-device scatter of the same block, bit for bit; every page but 26
    and the padding's null page 0 keeps its bits, and so does every page
    of the source."""
    _, eng = gather_engine
    src, dst = _global(eng, dt, seed=6), _global(eng, dt, seed=7)
    b = eng.max_pages_per_req
    idx_src = torch.zeros(b, dtype=torch.int32)
    idx_dst = torch.zeros(b, dtype=torch.int32)
    idx_src[0], idx_dst[0] = 9, eng.pool_physical_pages // 2 + 5
    pool_s = eng.paged_cache(dt, mesh)
    models.relayout_cache(pool_s, src)
    block = steps.make_page_gather_fn()(None, pool_s, idx_src)
    with Engine(eng.cfg, eng.params, eng.ecfg, device="cpu") as other:
        pool_d = other.paged_cache(dt, mesh)  # a second pool, same layout
        models.relayout_cache(pool_d, dst)
        steps.make_page_scatter_fn()(None, pool_d, idx_dst, *block)
        after = [{n: torch.empty_like(t) for n, t in d.items()} for d in dst]
        models.relayout_cache(after, pool_d)
    src_after = [{n: torch.empty_like(t) for n, t in d.items()} for d in src]
    models.relayout_cache(src_after, pool_s)
    one = [{n: t.clone() for n, t in d.items()} for d in dst]
    one_block = steps.make_page_gather_fn()(None, src, idx_src)
    steps.make_page_scatter_fn()(None, one, idx_dst, *one_block)
    moved = {int(idx_dst[0]), 0}
    keep = [p for p in range(eng.pool_physical_pages) if p not in moved]
    for (i, n) in steps.page_leaves(dst):
        got = after[i][n].numpy()
        np.testing.assert_array_equal(_bits(got), _bits(one[i][n].numpy()))
        np.testing.assert_array_equal(_bits(got[:, keep]),
                                      _bits(dst[i][n].numpy()[:, keep]))
        np.testing.assert_array_equal(_bits(got[:, int(idx_dst[0])]),
                                      _bits(src[i][n].numpy()[:, 9]))
        np.testing.assert_array_equal(_bits(src_after[i][n].numpy()),
                                      _bits(src[i][n].numpy()))


@pytest.mark.parametrize("seed", range(4))
def test_two_shard_migration_conserves_refcounts_and_shards(seed):
    """``kvcache.migrate_pages`` between two-shard pools (the ``2x1``
    decode pool and the prefill pool of the same geometry), both ways:
    the summed refcounts and page balance hold, and every imported page
    lies in the shard it was asked for."""
    rng = np.random.default_rng(seed)
    pools = [kvcache.PagePool(num_pages=16, page_size=4, shards=2),
             kvcache.PagePool(num_pages=16, page_size=4, shards=2)]
    live: list[tuple[int, int]] = []
    for op in rng.integers(0, 4, size=200):
        if op == 0:
            i, sh = int(rng.integers(2)), int(rng.integers(2))
            pid = pools[i].alloc(sh)
            if pid is not None:
                assert pools[i].shard_of(pid) == sh
                live.append((i, pid))
        elif op == 1 and live:
            i, pid = live.pop(int(rng.integers(len(live))))
            pools[i].decref(pid)
        elif op >= 2 and live:
            i, pid = live[int(rng.integers(len(live)))]
            sh = int(rng.integers(2))
            try:
                mapping = kvcache.migrate_pages(pools[i], pools[1 - i],
                                                [pid], sh)
            except kvcache.KVCacheError:
                continue
            assert pools[1 - i].shard_of(mapping[pid]) == sh
            assert not pools[1 - i].is_null(mapping[pid])
            live = [(1 - i, mapping[p]) if (j, p) == (i, pid) else (j, p)
                    for j, p in live]
        for p in pools:
            p.check()
        assert sum(p.pages_in_use for p in pools) == len(set(live))
        assert sum(pools[j].refcount(p) for j, p in set(live)) == len(live)


def test_launcher_serves_a_split_of_meshes(jax_run, capsys):
    from repro_torch.launch import serve as tlaunch

    rep = tlaunch.main(LAUNCH + ["--device", "cpu", "--devices",
                                 "cpu cpu cpu cpu"])
    capsys.readouterr()
    # the paged report's keys are the JAX launcher's, but for the port's
    # own settings (the attention implementation, graphs, the device), its
    # count of mesh rebinds, and the JAX pipeline's overlapped-upload count
    # (the port stages uploads in pinned buffers and does not count them)
    assert set(rep) - set(jax_run["launcher"]) == PORT_KEYS
    assert set(jax_run["launcher"]) - set(rep) == {"h2d_overlapped"}
    assert rep["mesh"] == "1x2" and rep["disagg"]
    assert rep["migrations"] > 0 and rep["compiles_after_warmup"] == 0
    assert rep["finished"] == 4
