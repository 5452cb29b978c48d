"""Disaggregated prefill/decode with live KV-page migration (DESIGN.md
§17), against the JAX package.

The port runs both slices of the split on logical devices named in
``EngineConfig.devices`` (here ``("cpu", "cpu")``: two pools on one CPU),
the counterpart of the reference's two fake XLA devices
(``tests/test_disagg.py``). On the reference's ``BASE`` config and its
``mixed()`` stream (one decode-heavy request beside long prompts, all at
t=0; olmo-1b smoke, fp32, the JAX weights):

- the port's disaggregated greedy tokens for {sync, async} x {fp32, int8}
  equal the JAX package's shared stream (in process) and the port's shared
  stream, with migrations and 0 builds after warmup;
- migrations, migrated pages, the steps of each lane and ``disagg_rebinds``
  (2 on split -> collapse -> split) equal one JAX run on 2 fake devices, in
  one subprocess (fp32 sync, and the rebind arm), and so do the tokens and
  the warmed key set (the ``mesh`` coordinate and the ``mg`` lane);
- a prompt repeated after its migration hits the prefix trie;
- the disaggregated stream through emulated graph targets equals eager.

Page migration itself: a seeded fuzz of ``kvcache.migrate_pages`` across two
pools conserves refcounts (the counterpart of ``tests/test_properties.py``'s
property), and the ``mg`` targets' gather and scatter equal the JAX
package's ``make_page_gather_fn`` / ``make_page_scatter_fn`` on the same
fp32 and int8 caches. Tolerance: exact.
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

from repro_torch.configs import get_config
from repro_torch.runtime import kvcache, steps
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.serve import Engine, EngineConfig, run_paged_stream
from test_torch_faults import jaxpkg, tparams  # noqa: F401 (fixtures)
from test_torch_graphs import _emulated
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(max_len=48, batch_quantum=2, max_batch=4, page_size=8,
            num_pages=40, prefill_chunk=8, token_budget=8)
SPLIT = dict(mesh="1x1", meshes=("1x1@1",), devices=("cpu", "cpu"))


def mixed(Request, vocab: int, seed=0, n_long=4, n_decode=1) -> list:
    """The reference's stream: one decode-heavy request holding a slot plus
    a backlog of long prompts, so every long prompt crosses PREFILL ->
    DECODE and the split must migrate its pages."""
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=0, new_tokens=24, greedy=True, arrival_s=0.0,
                    prompt=tuple(int(x) for x in rng.integers(0, vocab, 8)))
            for _ in range(n_decode)]
    for _ in range(n_long):
        reqs.append(Request(
            rid=len(reqs), new_tokens=3, greedy=True, arrival_s=0.0,
            prompt=tuple(int(x) for x in rng.integers(0, vocab, 24))))
    return reqs


def _rebind_arm(cb, reqs) -> list:
    """The reference's split -> collapse -> split loop."""
    pending, done, t, step_i = list(reqs), [], 0.0, 0
    while pending or cb.has_work:
        if step_i == 4:
            cb.set_disagg(False, now=t)  # collapse: live prefills migrate
        elif step_i == 8:
            cb.set_disagg(True, now=t)  # re-split mid-stream
        if pending and cb.free_slots:
            take = min(len(pending), cb.free_slots)
            cb.admit(pending[:take], now=t)
            del pending[:take]
        done += cb.step(now=t)
        step_i += 1
        t += 0.05
        assert step_i < 400, "rebind arm did not drain"
    return done + cb.flush()


_SUBPROCESS = """
import json
import jax, numpy as np
from repro import models
from repro.configs import get_config
from repro.core import reset_entry_points
from repro.runtime.scheduler import Request
from repro.runtime.serve import Engine, EngineConfig, run_paged_stream

cfg = get_config('olmo-1b').smoke()
params = models.init_params(cfg, jax.random.PRNGKey(0))
reset_entry_points()
eng = Engine(cfg, params, EngineConfig(mesh='1x1', meshes=('1x1@1',),
                                       **BASE))
rs = mixed(Request, cfg.vocab_size)
rep = run_paged_stream(eng, rs, slots=4, disagg=True)
out = {'keys': sorted(repr(k) for k in eng._decode.cache.keys())}
out['matrix'] = dict(
    tokens=[list(r.tokens) for r in rs], migrations=rep['migrations'],
    migrated_pages=rep['migrated_pages'], lane_steps=rep['lane_steps'],
    steps=rep['steps'], compiles=rep['compiles_after_warmup'])
rebinds0 = int(eng.telemetry.registry.value('disagg_rebinds_total'))
cb = eng.paged_continuous(slots=4, disagg=True)
rs = mixed(Request, cfg.vocab_size, seed=3)
done = _rebind_arm(cb, rs)
out['rebind'] = dict(
    finished=len(done), tokens=[list(r.tokens) for r in rs],
    rebinds=int(eng.telemetry.registry.value('disagg_rebinds_total'))
    - rebinds0,
    migrations=cb.stats.migrations, migrated_pages=cb.stats.migrated_pages,
    lane_steps=cb.stats.lane_steps, compiles=eng.post_warmup_compiles)
eng.close()
print('RESULT ' + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_two_devices():
    """One JAX run on 2 fake devices (the pytest process sees one)."""
    pytest.importorskip("jax")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=os.path.join(REPO, "src"),
    )
    code = "\n".join([
        "import numpy as np", f"BASE = {BASE!r}", inspect.getsource(mixed),
        inspect.getsource(_rebind_arm), textwrap.dedent(_SUBPROCESS)])
    out = subprocess.run(
        [sys.executable, "-c", code], env=env,
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def engines(jaxpkg, tparams):  # noqa: F811
    """The port's engines (fp32 and int8 pools, both warmed for the split),
    the JAX package's shared-stream tokens per pool dtype, and its fp32
    engine."""
    cfg = get_config("olmo-1b").smoke()
    port, jax_tokens, jax_engines = {}, {}, {}
    jaxpkg["reset"]()
    for dt in ("fp32", "int8"):
        jeng = jax_engines[dt] = jaxpkg["serve"].Engine(
            jaxpkg["cfg"], jaxpkg["params"],
            jaxpkg["serve"].EngineConfig(kv_dtype=dt, **BASE),
        )
        reqs = mixed(jaxpkg["sched"].Request, cfg.vocab_size)
        jaxpkg["serve"].run_paged_stream(jeng, reqs, slots=4)
        jax_tokens[dt] = [list(r.tokens) for r in reqs]
        port[dt] = Engine(cfg, tparams,
                          EngineConfig(kv_dtype=dt, **BASE, **SPLIT),
                          device="cpu")
    yield cfg, port, jax_tokens, jax_engines["fp32"]
    for eng in (*port.values(), *jax_engines.values()):
        eng.close()


@pytest.mark.parametrize("async_steps", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_disagg_tokens_equal_shared_and_jax(engines, kv_dtype, async_steps):
    cfg, port, jax_tokens, _ = engines
    eng = port[kv_dtype]
    shared = mixed(Request, cfg.vocab_size)
    rep_s = run_paged_stream(eng, shared, slots=4, async_steps=async_steps)
    split = mixed(Request, cfg.vocab_size)
    rep_d = run_paged_stream(eng, split, slots=4, disagg=True,
                             async_steps=async_steps)
    toks = [list(r.tokens) for r in split]
    assert toks == [list(r.tokens) for r in shared] == jax_tokens[kv_dtype]
    assert rep_d["disagg"] and not rep_s["disagg"]
    assert rep_d["migrations"] == 4 + 1  # every prompt crosses the split
    assert rep_d["finished"] == rep_s["finished"] == len(split)
    assert rep_s["compiles_after_warmup"] == rep_d["compiles_after_warmup"] == 0
    assert rep_d["mesh"] == "1x1" and rep_d["pool_shards"] == 1


def test_migrations_lanes_and_rebinds_equal_jax_on_two_devices(
    engines, jax_two_devices
):
    cfg, port, _, _ = engines
    eng = port["fp32"]
    reqs = mixed(Request, cfg.vocab_size)
    rep = run_paged_stream(eng, reqs, slots=4, disagg=True)
    want = jax_two_devices["matrix"]
    got = dict(tokens=[list(r.tokens) for r in reqs],
               migrations=rep["migrations"],
               migrated_pages=rep["migrated_pages"],
               lane_steps=rep["lane_steps"], steps=rep["steps"],
               compiles=rep["compiles_after_warmup"])
    assert got == want
    # the warmed keys, mesh coordinate and mg lane included, are the JAX
    # engine's for the same config and mesh ladder
    assert sorted(repr(k) for k in eng._decode.cache.keys()) == (
        jax_two_devices["keys"])
    # pages reckoned from the prompts: a prompt of 8 or 24 tokens at 8 a
    # page migrates every page it wrote on the prefill slice
    assert rep["migrated_pages"] == 1 + 4 * 3
    rebinds0 = int(eng.telemetry.registry.value("disagg_rebinds_total"))
    cb = eng.paged_continuous(slots=4, disagg=True)
    reqs = mixed(Request, cfg.vocab_size, seed=3)
    done = _rebind_arm(cb, reqs)
    got = dict(
        finished=len(done), tokens=[list(r.tokens) for r in reqs],
        rebinds=int(eng.telemetry.registry.value("disagg_rebinds_total"))
        - rebinds0,
        migrations=cb.stats.migrations,
        migrated_pages=cb.stats.migrated_pages,
        lane_steps=cb.stats.lane_steps, compiles=eng.post_warmup_compiles)
    assert got == jax_two_devices["rebind"]
    assert got["rebinds"] == 2 and got["compiles"] == 0


def test_prefix_trie_hit_after_a_migrated_fork(engines, jaxpkg):  # noqa: F811
    """A's prompt pages are written on the prefill slice and migrate at its
    flip; they still reach the trie, so B (the same prompt, later) adopts
    two full pages and decodes the same tail, as the shared stream does."""
    cfg, port, _, jeng = engines
    prompt = tuple(int(x) for x in np.random.default_rng(7).integers(
        0, cfg.vocab_size, 24))

    def pair(Request):
        return [Request(rid=0, new_tokens=4, greedy=True, arrival_s=0.0,
                        prompt=prompt),
                Request(rid=1, new_tokens=4, greedy=True, arrival_s=5.0,
                        prompt=prompt)]

    a, b = pair(Request)
    rep = run_paged_stream(port["fp32"], [a, b], slots=4, disagg=True)
    assert rep["migrations"] > 0 and rep["shared_prompt_tokens"] >= 16
    assert a.tokens == b.tokens
    assert rep["finished"] == 2 and rep["compiles_after_warmup"] == 0
    ja, jb = pair(jaxpkg["sched"].Request)
    jrep = jaxpkg["serve"].run_paged_stream(jeng, [ja, jb], slots=4)
    assert (a.tokens, b.tokens) == (list(ja.tokens), list(jb.tokens))
    assert rep["shared_prompt_tokens"] == jrep["shared_prompt_tokens"]


def test_disagg_through_emulated_graphs_equals_eager(engines, tparams,  # noqa: F811
                                                     monkeypatch):
    """Captured targets are bound to one pool each: the prefill slice's
    ``pf`` and ``mg`` targets run over its own pool, the decode slice's
    over the other, static inputs written as a replay writes them."""
    cfg, port, _, _ = engines
    want = mixed(Request, cfg.vocab_size)
    run_paged_stream(port["fp32"], want, slots=4, disagg=True)
    with Engine(cfg, tparams, EngineConfig(**BASE, **SPLIT),
                device="cpu") as eng:
        _emulated(monkeypatch, eng)
        got = mixed(Request, cfg.vocab_size)
        rep = run_paged_stream(eng, got, slots=4, disagg=True)
        pools = {id(t.graph.owned) for k, t in eng._decode.cache._table.items()
                 if k[0] in ("pf", "cbp", "mg")}
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert rep["compiles_after_warmup"] == 0 and len(pools) == 2


def test_the_two_slices_hold_distinct_pools(engines):
    _, port, _, _ = engines
    eng = port["int8"]
    eng.paged_continuous(slots=4, disagg=True)
    dec, pf = eng.paged_cache("int8", "1x1"), eng.paged_cache("int8", "1x1@1")
    for a, b in zip(dec, pf):
        for name in a:
            assert a[name].data_ptr() != b[name].data_ptr()


# ----------------------------------------------------------- page migration
@pytest.mark.parametrize("seed", range(6))
def test_cross_pool_migration_conserves_refcounts(seed):
    """Any interleaving of alloc/incref/decref with cross-pool migration
    (both directions, single pages and batches) keeps the summed refcount
    and the page balance across the two pools: references travel, never
    minted or dropped; a dry destination is an atomic no-op."""
    rng = np.random.default_rng(seed)
    pools = [kvcache.PagePool(num_pages=8, page_size=4),
             kvcache.PagePool(num_pages=8, page_size=4)]
    live: list[tuple[int, int]] = []
    for op in rng.integers(0, 5, size=200):
        if op == 0:
            i = int(rng.integers(2))
            pid = pools[i].alloc()
            if pid is not None:
                live.append((i, pid))
        elif op == 1 and live:
            i, pid = live[int(rng.integers(len(live)))]
            pools[i].incref(pid)
            live.append((i, pid))
        elif op == 2 and live:
            i, pid = live.pop(int(rng.integers(len(live))))
            pools[i].decref(pid)
        elif op >= 3 and live:
            i, pid = live[int(rng.integers(len(live)))]
            batch = [pid] if op == 3 else sorted({p for j, p in live if j == i})
            try:
                mapping = kvcache.migrate_pages(pools[i], pools[1 - i], batch)
            except kvcache.KVCacheError:
                continue
            live = [(1 - i, mapping[p]) if j == i and p in mapping else (j, p)
                    for j, p in live]
        for p in pools:
            p.check()
        held = {(j, p) for j, p in live}
        assert sum(p.pages_in_use for p in pools) == len(held)
        assert sum(pools[j].refcount(p) for j, p in held) == len(live)
    for i, pid in live:
        pools[i].decref(pid)
    for p in pools:
        p.check()
        assert p.pages_in_use == 0


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_page_gather_and_scatter_equal_jax(jaxpkg, kv_dtype):  # noqa: F811
    """Random pools, a padded index (live pages, then the null page): the
    block the port's gather reads and the pool its scatter writes equal the
    JAX package's on the same values."""
    jnp = jaxpkg["jax"].numpy
    from repro.runtime import steps as jsteps

    cfg = get_config("olmo-1b").smoke()
    from repro_torch import models

    src = models.init_paged_cache(cfg, 11, 8, kv_dtype)
    dst = models.init_paged_cache(cfg, 11, 8, kv_dtype)
    g = torch.Generator().manual_seed(4)
    for cache in (src, dst):
        for layer in cache:
            for t in layer.values():
                t.copy_(torch.randint(-100, 100, t.shape, generator=g)
                        if t.dtype == torch.int8
                        else torch.randn(t.shape, generator=g))
    idx_src = torch.tensor([3, 7, 1, 0, 0, 0], dtype=torch.int32)
    idx_dst = torch.tensor([9, 2, 5, 0, 0, 0], dtype=torch.int32)
    jsrc = [{n: jnp.asarray(t.numpy()) for n, t in layer.items()}
            for layer in src]
    jdst = [{n: jnp.asarray(t.numpy()) for n, t in layer.items()}
            for layer in dst]
    block = steps.make_page_gather_fn()(None, src, idx_src)
    jblock = jsteps.make_page_gather_fn()(jsrc, jnp.asarray(idx_src.numpy()))
    leaves = steps.page_leaves(src)
    for (i, n), b in zip(leaves, block):
        np.testing.assert_array_equal(b.numpy(), np.asarray(jblock[i][n]))
    steps.make_page_scatter_fn()(None, dst, idx_dst, *block)
    jout = jsteps.make_page_scatter_fn()(jdst, jblock,
                                         jnp.asarray(idx_dst.numpy()))
    for i, n in leaves:
        live = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]  # the null page: any writer
        np.testing.assert_array_equal(dst[i][n][:, live].numpy(),
                                      np.asarray(jout[i][n])[:, live])
