"""The port's dense continuous engine against the JAX package's, and the
dense cache's page view that puts its per-row attention on B1-B4.

``run_continuous_stream`` on ``olmo-1b``'s smoke config (fp32) with the JAX
package's weights (``params_from_jax``), both engines under one step clock
(every read of the clock advances it, so both loops admit the same requests
at the same steps): greedy token streams equal, ``lane_steps`` and
``prefill_chunks`` equal, no build after warmup. Four streams — prompt-less,
prompts through ``pfd``, prompts forced token by token, and speculation
(``dr``/``vfd``/``drp``) with an int8 draft cache, held against the JAX
package's int8 draft (ROADMAP C2) — and ``mamba2-370m``'s smoke config
through ``cb``. Six requests over four slots, so slots are reused and a
request joins at position 0 over its predecessor's rows.

The page view (``models.dense_page_view``): per-row dense attention with
``attn_impl="kernel"`` (on the CPU the paged kernels' plain versions over
the view) equals ``"plain"`` (``_decode_sdpa_rows`` over the whole cache)
within 1e-5 (fp32: the same products summed in another order), over model
dtype and int8 caches, every mode, a rejoin at position 0, positions at and
past ``max_len`` and idle chunk rows. The chunk write (a scatter of the
chunk's rows) leaves the same cache bits as the JAX package's masked
select. ``cuda``-marked cases hold B1-B4 over the view against their plain
versions on the card (tolerances as ``test_torch_kernels.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels, models
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch
from repro_torch.models import attention
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime.serve import Engine, EngineConfig, run_continuous_stream
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

LOGIT_TOL = 1e-5
VIEW_TOL = 1e-5
ENGINE = dict(max_len=64, max_batch=4)
SLOTS = 4
STREAMS = {
    "promptless": (dict(), 0),
    "chunked": (dict(prefill_chunk=16), 12),
    "token_by_token": (dict(), 12),
    "spec_int8_draft": (dict(prefill_chunk=16, spec_k=2, draft_layers=1,
                             draft_kv_dtype="int8"), 12),
}


class StepClock:
    """Virtual time that advances a fixed step per read: the stream loops
    of both packages read it alike, so they admit the same requests at the
    same steps."""

    def __init__(self, dt: float = 0.004) -> None:
        self.t = 0.0
        self.dt = dt

    def now(self) -> float:
        self.t += self.dt
        return self.t

    def jump_to(self, t: float) -> None:
        self.t = max(self.t, t)


def _traffic(sched, vocab: int, prompt_len: int,
             sample_frac: float = 0.0) -> list:
    """Six requests at 100 req/s, greedy unless ``sample_frac``; distinct
    prompts when asked."""
    reqs = sched.poisson_arrivals(6, 100.0, seed=5, tokens_mean=6,
                                  tokens_max=16, sample_frac=sample_frac,
                                  vocab=vocab)
    if prompt_len:
        sched.attach_distinct_prompts(reqs, prompt_len, vocab=vocab, seed=6)
    return reqs


@pytest.fixture(scope="module")
def smoke():
    jax = pytest.importorskip("jax")
    from repro import models as jm
    from repro.configs import get_config as jax_config
    from repro_torch.convert import params_from_jax

    cfg = jax_config("olmo-1b").smoke()
    jparams = jm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return cfg, get_config("olmo-1b").smoke(), jparams, tparams


@pytest.fixture(scope="module")
def jax_engines(smoke):
    """One JAX engine per engine configuration, for the whole module: a
    second ``continuous`` on an engine re-warms from its compiled keys."""
    from repro.core import reset_entry_points
    from repro.runtime import serve as jserve

    made: dict = {}

    def get(cfg, params, **kw):
        key = (cfg.name, tuple(sorted(kw.items())))
        if key not in made:
            reset_entry_points()
            made[key] = jserve.Engine(cfg, params,
                                      jserve.EngineConfig(**ENGINE, **kw))
        return made[key]

    yield get
    for eng in made.values():
        eng.close()


def _both(jeng, cfg, tcfg, tparams, ecfg: dict, prompt_len: int,
          sample_frac: float = 0.0):
    from repro.runtime import scheduler as jsched
    from repro.runtime import serve as jserve

    jreqs = _traffic(jsched, cfg.vocab_size, prompt_len, sample_frac)
    treqs = _traffic(tsched, cfg.vocab_size, prompt_len, sample_frac)
    jrep = jserve.run_continuous_stream(jeng, jreqs, slots=SLOTS,
                                        clock=StepClock())
    with Engine(tcfg, tparams, EngineConfig(**ENGINE, **ecfg),
                device="cpu") as eng:
        trep = run_continuous_stream(eng, treqs, slots=SLOTS,
                                     clock=StepClock())
    return jreqs, jrep, treqs, trep


# ---------------------------------------------------------------- streams
@pytest.mark.parametrize("name", list(STREAMS))
def test_continuous_stream_matches_jax(smoke, jax_engines, name):
    """Greedy streams, lane steps and prefill chunks equal to the JAX
    engine's; no build after warmup on either side."""
    cfg, tcfg, jparams, tparams = smoke
    ecfg, prompt_len = STREAMS[name]
    jreqs, jrep, treqs, trep = _both(
        jax_engines(cfg, jparams, **ecfg), cfg, tcfg, tparams, ecfg,
        prompt_len,
    )
    assert trep["finished"] == jrep["finished"] == len(treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert trep["compiles_after_warmup"] == jrep["compiles_after_warmup"] == 0
    assert trep["lane_steps"] == jrep["lane_steps"]
    assert trep["prefill_chunks"] == jrep["prefill_chunks"]
    assert trep["prompt_tokens"] == jrep["prompt_tokens"]
    assert trep["steps"] == jrep["steps"]
    if prompt_len and "prefill_chunk" in ecfg:
        assert trep["prefill_chunks"] > 0
    elif prompt_len:
        assert trep["prompt_tokens"] == len(treqs) * (prompt_len - 1)
    if "spec_k" in ecfg:
        assert trep["lane_steps"]["draft"] > 0
        assert trep["lane_steps"]["verify"] > 0
        assert trep["lane_calls"]["drp"] == jrep["lane_calls"]["drp"] > 0
        for key in ("drafted_tokens", "accepted_tokens"):
            assert trep["spec"][key] == jrep["spec"][key], key


@pytest.mark.parametrize("name", ["chunked", "spec_int8_draft"])
def test_sampled_continuous_stream_matches_jax(smoke, jax_engines, name):
    """Half the requests sampled (``cb``/``pfd``; with speculation the
    sampled rows ride ``vfd`` with windows of one while ``dr``/``drp``
    split and discard keys): every token, the lane steps and the steps
    equal the JAX engine's on the same engine configuration."""
    cfg, tcfg, jparams, tparams = smoke
    ecfg, prompt_len = STREAMS[name]
    jreqs, jrep, treqs, trep = _both(
        jax_engines(cfg, jparams, **ecfg), cfg, tcfg, tparams, ecfg,
        prompt_len, sample_frac=0.5,
    )
    assert trep["finished"] == jrep["finished"] == len(treqs)
    assert not all(r.greedy for r in treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert trep["lane_steps"] == jrep["lane_steps"]
    assert trep["steps"] == jrep["steps"]
    assert trep["compiles_after_warmup"] == 0


def test_mamba2_continuous_stream_matches_jax(jax_engines):
    """An SSM stack serves ``cb`` alone, its prompts forced token by token
    (``prefill_chunk`` and ``spec_k`` are gated off), with the JAX
    package's tokens: a joining slot inherits its predecessor's recurrent
    state in both packages."""
    jax = pytest.importorskip("jax")
    from repro import models as jm
    from repro.configs import get_config as jax_config
    from repro_torch.convert import params_from_jax

    cfg = jax_config("mamba2-370m").smoke()
    tcfg = get_config("mamba2-370m").smoke()
    jparams = jm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    ecfg = dict(prefill_chunk=16, spec_k=2)
    jreqs, jrep, treqs, trep = _both(
        jax_engines(cfg, jparams, **ecfg), cfg, tcfg, tparams, ecfg, 6
    )
    assert trep["finished"] == jrep["finished"] == len(treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert trep["compiles_after_warmup"] == jrep["compiles_after_warmup"] == 0
    assert trep["lane_steps"] == jrep["lane_steps"]
    assert trep["lane_steps"]["prefill"] == trep["lane_steps"]["draft"] == 0
    assert trep["prefill_chunk"] == trep["spec_k"] == 0
    assert trep["prompt_tokens"] == jrep["prompt_tokens"] == len(treqs) * 5
    # the cache a batcher starts from: the JAX engine's warmup state (the
    # zeroed cache after one dummy cb step), which an SSM slot carries
    jcache = jax_engines(cfg, jparams, **ecfg).continuous(slots=SLOTS)._cache
    with Engine(tcfg, tparams, EngineConfig(**ENGINE, **ecfg),
                device="cpu") as eng:
        tcache = eng.continuous(slots=SLOTS)._cache
    for s, slot in enumerate(tcache):
        for name, t in slot.items():
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(jcache[s][name], np.float32),
                                       atol=1e-5, rtol=1e-5, err_msg=name)
            assert t.abs().sum() > 0, name  # the dummy step wrote state


def test_mamba2_sampled_continuous_stream_matches_jax(jax_engines):
    """mamba2's ``cb`` stream with half the requests sampled: the keys
    split in every step, every token equal to the JAX engine's."""
    jax = pytest.importorskip("jax")
    from repro import models as jm
    from repro.configs import get_config as jax_config
    from repro_torch.convert import params_from_jax

    cfg = jax_config("mamba2-370m").smoke()
    tcfg = get_config("mamba2-370m").smoke()
    jparams = jm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    ecfg = dict(prefill_chunk=16, spec_k=2)
    jreqs, jrep, treqs, trep = _both(
        jax_engines(cfg, jparams, **ecfg), cfg, tcfg, tparams, ecfg, 6,
        sample_frac=0.5,
    )
    assert trep["finished"] == jrep["finished"] == len(treqs)
    assert not all(r.greedy for r in treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert trep["steps"] == jrep["steps"]
    assert trep["compiles_after_warmup"] == 0


def test_chunked_verify_step_matches_jax(smoke):
    """``chunked_verify_step`` logits over every window row (a row mid
    cache, one at 0, an idle row) within 1e-5 of the JAX function's, and
    the written rows equal."""
    import jax.numpy as jnp
    from repro import models as jm

    cfg, tcfg, jparams, tparams = smoke
    rng = np.random.default_rng(11)
    b, smax, c = 3, 32, 5
    tok = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
    start = np.array([9, 0, 20], np.int32)
    length = np.array([5, 3, 0], np.int32)
    jcache = jm.init_cache(cfg, b, smax)
    tcache = models.init_cache(tcfg, b, smax)
    prime = rng.integers(0, cfg.vocab_size, (b, 16)).astype(np.int32)
    full = np.full(b, 16, np.int32)
    zero = np.zeros(b, np.int32)
    _, jcache = jm.chunked_decode_step(cfg, jparams, jcache, jnp.asarray(prime),
                                       jnp.asarray(zero), jnp.asarray(full))
    models.chunked_decode_step(tcfg, tparams, tcache, torch.from_numpy(prime),
                               torch.from_numpy(zero), torch.from_numpy(full))
    jl, jcache = jm.chunked_verify_step(cfg, jparams, jcache, jnp.asarray(tok),
                                        jnp.asarray(start), jnp.asarray(length))
    tl, _ = models.chunked_verify_step(
        tcfg, tparams, tcache, torch.from_numpy(tok), torch.from_numpy(start),
        torch.from_numpy(length),
    )
    assert tl.shape == (b, c, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    for s, slot in enumerate(tcache):
        for name, t in slot.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jcache[s][name]),
                                       atol=1e-5, rtol=1e-5, err_msg=name)


# ------------------------------------------------------------ the page view
def _cfg(mode: str):
    """The smoke config in one attention mode; ``local`` for the window."""
    cfg = get_config("olmo-1b").smoke()
    if mode == "window":
        return dataclasses.replace(cfg, sliding_window=8), True
    if mode == "softcap":
        return dataclasses.replace(cfg, attn_logit_softcap=5.0), False
    return cfg, False


def _layer(cfg) -> dict:
    return models.layer_params(models.init_params(cfg, seed=2), 0, 0)["attn"]


def _filled_cache(cfg, b: int, smax: int, kv_dtype: str, seed: int) -> dict:
    """A dense cache full of an earlier occupant's rows."""
    g = torch.Generator().manual_seed(seed)
    cache = attention.init_kv_cache(cfg, b, smax, kv_dtype)
    shape = cache["k"].shape
    if kv_dtype == "int8":
        for name in ("k", "v"):
            cache[name].copy_(torch.randint(-127, 128, shape, generator=g))
        for name in ("ks", "vs"):
            cache[name].copy_(torch.rand(shape[:2], generator=g) * 0.02)
    else:
        for name in ("k", "v"):
            cache[name].copy_(torch.randn(shape, generator=g))
    return cache


def _clone(cache: dict) -> dict:
    return {k: t.clone() for k, t in cache.items()}


MODES = ["causal", "window", "softcap"]


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("smax", [32, 24])  # views of 16- and 8-row pages
def test_dense_decode_kernel_matches_plain(kv_dtype, mode, smax):
    """One token per row at positions 0 (a rejoin over an occupant's rows),
    mid cache, the last row and past the cache (writes nothing, attends
    every row): kernel over the view = plain, and the same writes."""
    cfg, local = _cfg(mode)
    p = _layer(cfg)
    pos = torch.tensor([0, 13, smax - 1, smax + 3], dtype=torch.int32)
    x = torch.randn(4, 1, cfg.d_model, generator=torch.Generator().manual_seed(3))
    base = _filled_cache(cfg, 4, smax, kv_dtype, seed=4)
    outs, caches = {}, {}
    for impl in ("kernel", "plain"):
        caches[impl] = _clone(base)
        outs[impl], _ = attention.decode_attention(
            cfg, p, x, caches[impl], pos, local=local, attn_impl=impl
        )
    torch.testing.assert_close(outs["kernel"], outs["plain"], atol=VIEW_TOL,
                               rtol=0)
    for name in base:
        assert torch.equal(caches["kernel"][name], caches["plain"][name]), name
    # the row past the cache wrote nothing
    for name in base:
        assert torch.equal(caches["plain"][name][3], base[name][3]), name


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("mode", MODES)
def test_dense_chunk_kernel_matches_plain(kv_dtype, mode):
    """Chunks from a rejoin at 0, mid cache, one that runs past
    ``max_len`` (its tail writes nothing), and an idle row (length 0):
    kernel over the view = plain, and the same writes."""
    cfg, local = _cfg(mode)
    p = _layer(cfg)
    smax, c = 32, 8
    start = torch.tensor([0, 10, 28, 5], dtype=torch.int32)
    length = torch.tensor([8, 3, 8, 0], dtype=torch.int32)
    x = torch.randn(4, c, cfg.d_model, generator=torch.Generator().manual_seed(5))
    base = _filled_cache(cfg, 4, smax, kv_dtype, seed=6)
    outs, caches = {}, {}
    for impl in ("kernel", "plain"):
        caches[impl] = _clone(base)
        outs[impl], _ = attention.chunked_decode_attention(
            cfg, p, x, caches[impl], start, length, local=local,
            attn_impl=impl,
        )
    torch.testing.assert_close(outs["kernel"], outs["plain"], atol=VIEW_TOL,
                               rtol=0)
    for name in base:
        assert torch.equal(caches["kernel"][name], caches["plain"][name]), name
        assert torch.equal(caches["plain"][name][3], base[name][3]), name


def _select_insert(t: torch.Tensor, new: torch.Tensor, start, length):
    """The JAX package's chunk write, a masked select over the whole cache:
    row j of batch row b takes chunk row j - start inside [start, start +
    length)."""
    c = new.shape[1]
    ki = torch.arange(t.shape[1])
    sel = (ki[None] >= start[:, None]) & (ki[None] < (start + length)[:, None])
    idx = (ki[None] - start[:, None]).clamp(0, c - 1).long()
    tail = new.shape[2:]
    at = idx.view(*idx.shape, *([1] * len(tail))).expand(*idx.shape, *tail)
    return torch.where(sel.view(*sel.shape, *([1] * len(tail))),
                       torch.gather(new, 1, at), t)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_chunk_scatter_writes_the_select_bits(kv_dtype):
    """The chunk's scatter leaves exactly the cache the masked select
    leaves, with idle rows, a chunk past ``max_len`` and a chunk as wide
    as the cache."""
    cfg, _ = _cfg("causal")
    p = _layer(cfg)
    smax, c = 16, 16
    start = torch.tensor([0, 3, 10, 7, 40], dtype=torch.int32)
    length = torch.tensor([16, 5, 16, 0, 2], dtype=torch.int32)
    x = torch.randn(5, c, cfg.d_model, generator=torch.Generator().manual_seed(7))
    cache = _filled_cache(cfg, 5, smax, kv_dtype, seed=8)
    positions = start[:, None] + torch.arange(c, dtype=torch.int32)[None]
    _, k, v = attention._qkv(cfg, p, x, positions)
    if kv_dtype == "int8":
        (qk, ks), (qv, vs) = (attention.quantise_kv_rows(t) for t in (k, v))
        new = {"k": qk, "v": qv, "ks": ks, "vs": vs}
    else:
        new = {"k": k, "v": v}
    want = {n: _select_insert(cache[n], new[n], start, length) for n in cache}
    attention.chunked_decode_attention(cfg, p, x, cache, start, length,
                                       local=False, attn_impl="plain")
    for name in cache:
        assert torch.equal(cache[name], want[name]), name


def test_dense_page_view_is_a_view_with_an_identity_table():
    cfg, _ = _cfg("causal")
    for kv_dtype in ("fp32", "int8"):
        cache = attention.init_kv_cache(cfg, 3, 48, kv_dtype)
        pool, table = attention.dense_page_view(cache)
        assert pool["k"].shape == (9, 16, cfg.num_kv_heads, cfg.head_dim)
        assert pool["k"].data_ptr() == cache["k"].data_ptr()
        assert table.dtype == torch.int32 and table.shape == (3, 3)
        assert table.tolist() == [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
        if kv_dtype == "int8":
            assert pool["k_scale"].shape == (9, 16)
            assert pool["v_scale"].data_ptr() == cache["vs"].data_ptr()
    assert attention.dense_page_size(24) == 8
    assert attention.dense_page_size(64) == 16


def test_a_shape_no_kernel_takes_raises():
    """A dense cache with no page view raises ``ValueError`` naming its
    ``max_len``, in ``dense_page_size`` and in the attention over it. An
    engine allocates its dense and draft caches with ``dense_rows(max_len)``
    rows (a multiple of 8), so it builds at any ``max_len`` and still
    admits by ``max_len``. A dtype and head_dim no kernel takes raises at
    build on the card (``build.check_head_dim``): bf16 at head_dim 32 is
    refused, bf16 at head_dim 64 (granite-moe's heads, on the tensor-core
    bodies) accepted."""
    from repro_torch.kernels import build

    cfg, _ = _cfg("causal")
    with pytest.raises(ValueError, match="max_len=20"):
        attention.dense_page_size(20)
    cache = attention.init_kv_cache(cfg, 2, 20)
    with pytest.raises(ValueError, match="max_len=20"):
        attention.decode_attention(
            cfg, _layer(cfg), torch.zeros(2, 1, cfg.d_model), cache,
            torch.zeros(2, dtype=torch.int32), local=False,
        )
    assert [models.dense_rows(n) for n in (20, 24, 100, 1024)] == [
        24, 24, 104, 1024]
    params = models.init_params(cfg, seed=0)
    with Engine(cfg, params, EngineConfig(max_len=20, max_batch=2),
                device="cpu") as eng:
        cb = eng.continuous(slots=2)
        assert cb.max_len == 20
        assert eng.dense_cache(2)[0]["k"].shape[2] == 24
        with pytest.raises(ValueError, match="max_len=20"):
            cb.admit([tsched.Request(rid=0, new_tokens=20, prompt=(1, 2))])
    with Engine(cfg, params, EngineConfig(max_len=20, max_batch=2,
                                          page_size=4, spec_k=2),
                device="cpu") as eng:
        assert eng.paged_continuous(slots=2).num_slots == 2
        assert eng.draft_cache(2, "fp32")[0]["k"].shape[2] == 24
    build.check_head_dim("cb", torch.bfloat16, 64)
    with pytest.raises(ValueError,
                       match="no kernel instantiated for torch.bfloat16 at "
                             "head_dim=32"):
        build.check_head_dim("cb", torch.bfloat16, 32)
    with pytest.raises(ValueError, match="no kernel instantiated.*head_dim=8"):
        build.check_head_dim("cb", torch.float32, 8)
    for dtype, dims in build.HEAD_DIMS.items():
        for hd in dims:
            build.check_head_dim("cb", dtype, hd)


def test_admission_seats_ascending_and_rejects_what_cannot_fit(smoke):
    _, tcfg, _, tparams = smoke
    with Engine(tcfg, tparams, EngineConfig(**ENGINE, prefill_chunk=16),
                device="cpu") as eng:
        cb = eng.continuous(slots=3)
        reqs = [tsched.Request(rid=i, new_tokens=4, prompt=(1, 2, 3))
                for i in range(2)]
        assert cb.admit(reqs) == 2
        assert cb._slots[:2] == reqs and cb._slots[2] is None
        assert list(cb._prefilling) == [True, True, False]
        with pytest.raises(ValueError, match="max_len=64"):
            cb.admit([tsched.Request(rid=9, new_tokens=60, prompt=(1,) * 6)])
        while cb.has_work:
            cb.step()
        assert all(len(r.tokens) == 4 for r in reqs)
        assert eng.post_warmup_compiles == 0


@pytest.mark.parametrize("arch,ecfg", [
    ("olmo-1b", dict(prefill_chunk=16, spec_k=2, draft_kv_dtype="int8")),
    ("mamba2-370m", dict()),
], ids=["olmo-spec-int8-draft", "mamba2"])
def test_stream_through_emulated_graphs_equals_eager(monkeypatch, arch, ecfg):
    """Graph targets whose capture is emulated on the CPU (a capture runs
    the step twice; a replay reruns it and clobbers every other target's
    static outputs, as a shared graph pool may) give the eager stream,
    sampled requests included: the batcher reads each static output before
    the next replay, and the cache it starts from does not depend on how
    many runs warmup took (an SSM slot's state would show it)."""
    from test_torch_graphs import _emulated

    cfg = get_config(arch).smoke()
    params = models.init_params(cfg, seed=0)
    out = {}
    for graphs in (True, False):
        reqs = _traffic(tsched, cfg.vocab_size, 10)
        for i, r in enumerate(reqs):
            r.greedy = i % 3 != 1  # a third sampled
        with Engine(cfg, params, EngineConfig(**ENGINE, **ecfg),
                    device="cpu") as eng:
            if graphs:
                _emulated(monkeypatch, eng)
            start = [{k: t.clone() for k, t in c.items()}
                     for c in eng.continuous(slots=SLOTS)._cache]
            rep = run_continuous_stream(eng, reqs, slots=SLOTS, seed=3,
                                        clock=StepClock())
            kinds = {type(t).__name__
                     for t in eng._decode.cache._table.values()}
        monkeypatch.undo()
        assert rep["finished"] == len(reqs)
        assert rep["compiles_after_warmup"] == 0
        assert kinds == {"_GraphStep" if graphs else "function"}
        out[graphs] = ({r.rid: r.tokens for r in reqs}, rep["lane_steps"],
                       rep["h2d_uploads"], start)
    (toks, steps, ups, start), want = out[True], out[False]
    assert (toks, steps, ups) == want[:3]
    for got, ref in zip(start, want[3]):
        for name in ref:
            assert torch.equal(got[name], ref[name]), name


# ----------------------------------------------------------------- launcher
def test_launcher_serves_continuous_and_both_on_the_cpu():
    rep = launch.main(["--engine", "continuous", "--smoke", "--device", "cpu",
                       "--requests", "5", "--max-len", "32", "--prompt-len",
                       "6", "--prefill-chunk", "8", "--slots", "3", "--json"])
    assert rep["engine"] == "continuous" and rep["slots"] == 3
    assert rep["finished"] == 5 and rep["prefill_chunks"] > 0
    assert rep["compiles_after_warmup"] == 0
    both = launch.main(["--engine", "both", "--smoke", "--device", "cpu",
                        "--requests", "4", "--max-len", "32", "--json"])
    assert set(both) == {"continuous", "burst"}
    assert both["continuous"]["finished"] == both["burst"]["finished"] == 4
    assert both["continuous"]["compiles_after_warmup"] == 0


@pytest.mark.parametrize("argv,msg", [
    (["--engine", "both", "--prompt-len", "8"], "--prompt-len"),
    (["--engine", "both", "--spec-k", "2"], "--spec-k"),
    (["--engine", "continuous", "--kv-dtype", "int8"], "--kv-dtype"),
    (["--engine", "continuous", "--slots", "-1"], "--slots"),
])
def test_launcher_flag_checks(argv, msg, capsys):
    with pytest.raises(SystemExit):
        launch.parse_args(argv)
    assert msg in capsys.readouterr().err


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh,atol", [(torch.float32, 16, 1e-4),
                                           (torch.bfloat16, 128, 2e-2)])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("smax", [64, 40])  # pages of 16 and of 8
def test_cuda_kernels_over_the_view_match_plain(cuda, dtype, dh, atol, int8,
                                                smax):
    """B1/B2 (B3/B4 over int8) on layer 1 of a stacked ``[3, S, max_len,
    KH, dh]`` cache whose other layers hold NaN: the kernels read only
    their layer's view and equal their plain versions at positions 0, mid,
    the last row and past the cache, and on chunks with an idle row."""
    g = torch.Generator().manual_seed(12)
    s, kh, h = 4, 2, 8
    shape = (3, s, smax, kh, dh)
    if int8:
        stacked = {n: torch.randint(-127, 128, shape, generator=g,
                                    dtype=torch.int8) for n in ("k", "v")}
        stacked.update({n: torch.rand(shape[:3], generator=g) * 0.02
                        for n in ("ks", "vs")})
        poisoned = ("ks", "vs")  # int8 has no NaN: poison the scales
    else:
        stacked = {n: torch.randn(shape, generator=g).to(dtype)
                   for n in ("k", "v")}
        poisoned = ("k", "v")
    for n in poisoned:
        stacked[n][0] = float("nan")
        stacked[n][2] = float("nan")
    layer = {n: t.to(cuda)[1] for n, t in stacked.items()}
    pool, table = attention.dense_page_view(layer)
    pages = [pool["k"], pool["v"]] + (
        [pool["k_scale"], pool["v_scale"]] if int8 else [])
    decode = (kernels.paged_decode_attention_int8 if int8
              else kernels.paged_decode_attention)
    prefill = (kernels.paged_prefill_attention_int8 if int8
               else kernels.paged_prefill_attention)
    dplain = (kernels.paged_decode_attention_int8_plain if int8
              else kernels.paged_decode_attention_plain)
    pplain = (kernels.paged_prefill_attention_int8_plain if int8
              else kernels.paged_prefill_attention_plain)
    fl = [t.float() if t.is_floating_point() and not int8 else t
          for t in pages]
    pos = torch.tensor([0, smax // 2, smax - 1, smax + 5], dtype=torch.int32,
                       device=cuda)
    q = torch.randn(s, h, dh, generator=g).to(cuda, dtype)
    out = decode(q, *pages, table, pos)
    ref = dplain(q.float(), *fl, table, pos)
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)
    start = torch.tensor([0, 7, smax - 3, 2], dtype=torch.int32, device=cuda)
    qc = torch.randn(s, 5, h, dh, generator=g).to(cuda, dtype)
    out = prefill(qc, *pages, table, start)
    ref = pplain(qc.float(), *fl, table, start)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)
