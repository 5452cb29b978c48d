"""The rest of the dense model path in the port against the JAX package:
qwen3-14b, gemma2-27b and hft-demo, and the dense cache at any ``max_len``.

Each ported config equals the reference's field by field (its ``smoke()``
too), with the reference's ``param_counts``. On the smoke configs of
qwen3-14b (``qk_norm``, an untied head) and gemma2-27b (local and global
layers with a window of 16, softcaps 50 and 30, GeGLU, ``embed_scale``), a
qwen3 variant of 10 heads over 2 kv heads (a GQA group of 5, as the full
model's 40 over 8) and hft-demo at full width (4 layers, d_model 256, 4
heads of 64, window 128, fp32; the kernels' plain versions stand for B1-B7
on the CPU): ``forward`` logits of ``naive``, ``chunked`` and ``kernel``
within 1e-5 of the JAX package's (fp32, the same products summed in
another order; ROADMAP C1), then greedy streams of gemma2-27b and the
group-5 qwen3 through the paged engine (chunked prefill, and speculation
with an int8 draft), the dense continuous engine and the per-burst engine
equal to the JAX engine's under one step clock. Weights are the JAX package's ``init_params`` through
``params_from_jax``; prompts come from a numpy seed.

The dense cache at a ``max_len`` that is not a multiple of 8 (ROADMAP C12):
at ``max_len`` 100 the dense continuous stream and the paged spec stream
(whose draft cache is dense) equal the JAX engine's, requests filling the
cache to its last row.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime import serve as tserve
from repro_torch.runtime.serve import Engine, EngineConfig

LOGIT_TOL = 1e-5
PARAM_COUNTS = {"qwen3-14b": 14_768_307_200, "gemma2-27b": 27_226_704_384,
                "hft-demo": 4_458_752}
# smoke models on the CPU: window 16 (gemma2), prompts past it
PAGED = dict(max_len=32, max_batch=4, page_size=8, num_pages=24,
             prefill_chunk=16)
SPEC = dict(PAGED, prefill_chunk=8, spec_k=2, draft_layers=1,
            draft_kv_dtype="int8")
DENSE = dict(max_len=32, max_batch=4, prefill_chunk=16)
BURST = dict(max_len=32, max_batch=8, batch_quantum=4)
SLOTS = 4


class StepClock:
    """Virtual time that advances a fixed step per read: both packages'
    loops admit the same requests at the same steps."""

    def __init__(self, dt: float = 0.004) -> None:
        self.t = 0.0
        self.dt = dt

    def now(self) -> float:
        self.t += self.dt
        return self.t

    def jump_to(self, t: float) -> None:
        self.t = max(self.t, t)


def _variant(cfg, name: str):
    if name == "qwen3-g5":
        return dataclasses.replace(cfg, num_heads=10, num_kv_heads=2)
    return cfg


ARCHS = {"qwen3": ("qwen3-14b", True), "gemma2": ("gemma2-27b", True),
         "qwen3-g5": ("qwen3-14b", True), "hft-demo": ("hft-demo", False)}


@pytest.fixture(scope="module")
def archs():
    """name -> (JAX config, port config, JAX params, port params), made on
    first use."""
    jax = pytest.importorskip("jax")
    from repro import models as jm
    from repro.configs import get_config as jax_config
    from repro_torch.convert import params_from_jax

    made: dict = {}

    def get(name: str):
        if name not in made:
            arch, smoke = ARCHS[name]
            jcfg, tcfg = jax_config(arch), get_config(arch)
            if smoke:
                jcfg, tcfg = jcfg.smoke(), tcfg.smoke()
            jcfg, tcfg = _variant(jcfg, name), _variant(tcfg, name)
            jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
            tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
            made[name] = (jcfg, tcfg, jparams, tparams)
        return made[name]

    return get


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", list(PARAM_COUNTS))
def test_config_equals_the_reference_field_by_field(arch):
    from repro.configs import get_config as jax_config

    jcfg, tcfg = jax_config(arch), get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.smoke()) == dataclasses.asdict(jcfg.smoke())
    assert tcfg.param_counts() == jcfg.param_counts()
    assert tcfg.param_counts()["total"] == PARAM_COUNTS[arch]
    assert tcfg.kv_dim == jcfg.kv_dim == tcfg.num_kv_heads * tcfg.head_dim
    assert get_config("olmo-1b").param_counts() == jax_config(
        "olmo-1b").param_counts()


def test_init_params_counts_and_draws_in_slabs():
    """``init_params`` gives ``param_counts`` parameters in the model
    dtype, and the same shapes and scales when every slab it draws is one
    row or less."""
    cfg = get_config("hft-demo")
    params = models.init_params(cfg, seed=0)
    assert sum(t.numel() for t in params.values()) == PARAM_COUNTS["hft-demo"]
    assert all(t.dtype == torch.float32 for t in params.values())
    old = models.model._DRAW_ELEMS
    try:
        models.model._DRAW_ELEMS = 1000  # every slab one row or less
        small = models.init_params(cfg, seed=0)
    finally:
        models.model._DRAW_ELEMS = old
    assert small.keys() == params.keys()
    for name, t in params.items():
        assert small[name].shape == t.shape, name
        assert torch.isfinite(small[name]).all(), name
    std = small["blocks.0.mlp.w_down"].float().std().item()
    assert abs(std - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5


# ---------------------------------------------------------------- forward
def _tokens(cfg, batch: int, seq: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_logits(archs):
    """name -> (tokens, the JAX package's naive ``forward`` logits) over a
    sequence past the window (hft-demo at full width: 160 > 128)."""
    made: dict = {}

    def get(name: str):
        if name not in made:
            import jax.numpy as jnp
            from repro import models as jm

            jcfg, _, jparams, _ = archs(name)
            tok = (_tokens(jcfg, 1, 160) if name == "hft-demo"
                   else _tokens(jcfg, 2, 40))
            jl, _ = jm.forward(jcfg, jparams, jnp.asarray(tok), remat=False)
            made[name] = tok, np.asarray(jl)
        return made[name]

    return get


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_forward_matches_jax(archs, jax_logits, name, impl):
    """Logits within 1e-5 of the JAX package's."""
    _, tcfg, _, tparams = archs(name)
    tok, jl = jax_logits(name)
    tl, _ = models.forward(tcfg, tparams, torch.from_numpy(tok), impl=impl)
    assert tl.shape == jl.shape == (*tok.shape, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("name", ["gemma2", "hft-demo"])
def test_the_window_masks(archs, name):
    """The local layers' window changes the logits of every position past
    it and of none before it: the same weights with the window off give
    other logits from position ``window`` on."""
    _, tcfg, _, tparams = archs(name)
    w = tcfg.sliding_window
    tok = torch.from_numpy(_tokens(tcfg, 1, w + 24, seed=3))
    for impl in ("naive", "kernel"):
        on, _ = models.forward(tcfg, tparams, tok, impl=impl)
        off, _ = models.forward(dataclasses.replace(tcfg, sliding_window=None),
                                tparams, tok, impl=impl)
        torch.testing.assert_close(on[:, :w], off[:, :w], atol=LOGIT_TOL,
                                   rtol=0)
        gap = (on[:, w:] - off[:, w:]).abs().amax(dim=-1)
        assert (gap > 1e-4).all(), (impl, gap)


# ---------------------------------------------------------------- streams
def _prompt_reqs(sched, vocab: int, n: int, prompt_len: int, new_tokens: int,
                 seed: int = 7) -> list:
    rng = np.random.default_rng(seed)
    return [
        sched.Request(rid=i, new_tokens=new_tokens + i % 3, greedy=True,
                      arrival_s=0.002 * i, prompt=tuple(
                          int(x) for x in rng.integers(0, vocab,
                                                       prompt_len + 2 * i)))
        for i in range(n)
    ]


def _burst_reqs(sched, vocab: int) -> list:
    """8 greedy requests in two waves (5, then 3): buckets 8 and 4."""
    reqs = sched.poisson_arrivals(8, 50.0, seed=3, tokens_mean=8,
                                  tokens_max=24, sample_frac=0.0, vocab=vocab)
    for i, r in enumerate(reqs):
        r.arrival_s = 0.0 if i < 5 else 1.0
    return reqs


def _run(engine: str, run_mod, eng, reqs) -> dict:
    if engine == "burst":
        return run_mod.run_burst_stream(eng, reqs, clock=StepClock())
    if engine == "continuous":
        return run_mod.run_continuous_stream(eng, reqs, slots=SLOTS,
                                             clock=StepClock())
    return run_mod.run_paged_stream(eng, reqs, slots=SLOTS, clock=StepClock())


def _near_tie(jcfg, jparams, prompt, tokens, i: int) -> bool:
    """Top-2 margin of the JAX logits that chose ``tokens[i]``."""
    import jax.numpy as jnp
    from repro import models as jm

    seq = list(prompt) + list(tokens[:i])
    logits, _ = jm.forward(jcfg, jparams, jnp.asarray([seq], np.int32),
                           remat=False)
    top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top2[1] - top2[0]) < LOGIT_TOL


def _match_jax(jcfg, tcfg, jparams, tparams, engine: str, ecfg: dict,
               traffic) -> tuple[dict, dict]:
    """The same requests through the JAX engine and the port's (CPU) under
    one step clock: greedy tokens equal (a first divergence only at a
    near-tie of the JAX logits), every request finished, no build after
    warmup on the continuous engines and the burst engine's builds equal."""
    from repro.core import reset_entry_points
    from repro.runtime import scheduler as jsched
    from repro.runtime import serve as jserve

    reset_entry_points()
    jreqs, treqs = traffic(jsched), traffic(tsched)
    with jserve.Engine(jcfg, jparams, jserve.EngineConfig(**ecfg)) as jeng:
        jrep = _run(engine, jserve, jeng, jreqs)
    with Engine(tcfg, tparams, EngineConfig(**ecfg), device="cpu") as eng:
        trep = _run(engine, tserve, eng, treqs)
    assert trep["finished"] == jrep["finished"] == len(treqs)
    assert trep["compiles_after_warmup"] == jrep["compiles_after_warmup"]
    if engine != "burst":
        assert trep["compiles_after_warmup"] == 0
    jby = {r.rid: r for r in jreqs}
    for r in treqs:
        j = jby[r.rid]
        assert len(r.tokens) == r.new_tokens, r.rid
        if r.tokens != j.tokens:
            i = next(i for i, (a, b) in enumerate(zip(r.tokens, j.tokens))
                     if a != b)
            assert _near_tie(jcfg, jparams, j.effective_prompt, j.tokens, i), (
                r.rid, i)
    return jrep, trep


STREAMS = {
    "paged": ("paged", PAGED),
    "paged-spec-int8-draft": ("paged", SPEC),
    "continuous": ("continuous", DENSE),
    "burst": ("burst", BURST),
}


@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("name", ["qwen3-g5", "gemma2"])
def test_streams_match_jax(archs, name, stream):
    """Prompts of 18-24 tokens (past gemma2's smoke window of 16) and 6-8
    greedy tokens through each engine, equal to the JAX engine's; the
    speculative lanes and the chunk lanes ran. qwen3-14b streams as its
    smoke config with 10 heads over 2 kv heads, the GQA group of the full
    model's 40 over 8 (B1, B2 and B5 at group 5; the smoke's own group of
    2 is gemma2-27b's smoke group, streamed here too)."""
    jcfg, tcfg, jparams, tparams = archs(name)
    if name == "qwen3-g5":
        assert tcfg.num_heads // tcfg.num_kv_heads == 5
    engine, ecfg = STREAMS[stream]
    if engine == "burst":
        def traffic(sched):
            return _burst_reqs(sched, tcfg.vocab_size)
    else:
        def traffic(sched):
            return _prompt_reqs(sched, tcfg.vocab_size, 4, 18, 6)
    _, trep = _match_jax(jcfg, tcfg, jparams, tparams, engine, ecfg, traffic)
    if engine != "burst":
        assert trep["prefill_chunks"] > 0
    if "spec_k" in ecfg:
        assert trep["lane_steps"]["draft"] > 0
        assert trep["lane_steps"]["verify"] > 0


def test_hft_demo_full_width_paged_stream_matches_jax(archs):
    """hft-demo at full width (head_dim 64, fp32): prompts of 130-134
    tokens, past its 128 window, through chunked prefill and decode."""
    jcfg, tcfg, jparams, tparams = archs("hft-demo")
    ecfg = dict(max_len=160, max_batch=4, page_size=16, num_pages=36,
                prefill_chunk=16)
    _, trep = _match_jax(
        jcfg, tcfg, jparams, tparams, "paged", ecfg,
        lambda sched: _prompt_reqs(sched, tcfg.vocab_size, 3, 130, 8))
    assert trep["prefill_chunks"] > 0


# ------------------------------------------------- C12: any max_len
@pytest.mark.parametrize("engine,ecfg", [
    ("continuous", dict(max_len=100, max_batch=4, prefill_chunk=16)),
    ("paged", dict(max_len=100, max_batch=4, page_size=16, num_pages=28,
                   prefill_chunk=16, spec_k=2, draft_layers=1)),
], ids=["continuous", "paged-spec"])
def test_max_len_100_streams_match_jax(engine, ecfg):
    """``max_len`` 100 (no multiple of 8): the port's dense caches hold 104
    rows and admission holds requests to 100 positions; requests whose
    prompt and tokens fill the cache to its last row (80 + 21 - 1 = 100)
    stream as the JAX engine's."""
    jax = pytest.importorskip("jax")
    from repro import models as jm
    from repro.configs import get_config as jax_config
    from repro_torch.convert import params_from_jax

    jcfg = jax_config("olmo-1b").smoke()
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    tcfg = get_config("olmo-1b").smoke()

    def traffic(sched):
        reqs = _prompt_reqs(sched, tcfg.vocab_size, 3, 60, 8)
        reqs.append(sched.Request(rid=9, new_tokens=21, greedy=True,
                                  arrival_s=0.0, prompt=tuple(range(1, 81))))
        return reqs

    _, trep = _match_jax(jcfg, tcfg, jparams, tparams, engine, ecfg, traffic)
    assert trep["prefill_chunks"] > 0
    if "spec_k" in ecfg:
        assert trep["lane_steps"]["verify"] > 0
