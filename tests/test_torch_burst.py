"""The port's per-burst engine against the JAX package's.

``Engine.set_mode`` + ``Engine.decode_loop`` and ``run_burst_stream`` on
``olmo-1b``'s smoke config (fp32) with the JAX package's weights
(``params_from_jax``). Both engines run under one virtual clock (time moves
only by jumps to the next arrival), so the bursts they form are the same and
their cold-path counters — ``mode_switches``, ``compiles_total``,
``compiles_after_warmup``, ``rebinds`` — must be equal. Tokens must be
equal, sampled ones too: each burst draws its key from
``np.random.default_rng(0)`` and ``decode_loop`` splits it into one
threefry key per step, in both packages (``repro_torch.prng``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_config as jax_config
from repro.models.model import pad_cache as jax_pad_cache
from repro.runtime import scheduler as jsched
from repro.runtime import serve as jserve
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import DispatchError
from repro_torch.launch import serve as launch
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime.serve import (
    Engine,
    EngineConfig,
    run_burst_stream,
)

ENGINE = dict(max_len=32, max_batch=8, batch_quantum=4)
TRAFFIC = dict(seed=3, tokens_mean=6, tokens_max=20, sample_frac=0.25)


class VirtualClock:
    """Time moves only when the stream loop jumps to the next arrival."""

    def __init__(self) -> None:
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def jump_to(self, t: float) -> None:
        self.t = max(self.t, t)


@pytest.fixture(scope="module")
def smoke():
    cfg = jax_config("olmo-1b").smoke()
    jparams = jm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return cfg, get_config("olmo-1b").smoke(), jparams, tparams


def _traffic(sched, vocab: int):
    """8 requests in two waves (5 then 3), a quarter sampled: bursts of
    buckets 8 and 4 in both modes."""
    reqs = sched.poisson_arrivals(8, 50.0, vocab=vocab, **TRAFFIC)
    for i, r in enumerate(reqs):
        r.arrival_s = 0.0 if i < 5 else 1.0
    return reqs


def test_form_bursts_matches_jax(smoke):
    cfg = smoke[0]
    j = jsched.form_bursts(_traffic(jsched, cfg.vocab_size), quantum=4,
                           max_batch=4)
    t = tsched.form_bursts(_traffic(tsched, cfg.vocab_size), quantum=4,
                           max_batch=4)
    assert [(b, g, [r.rid for r in c]) for b, g, c in t] == [
        (b, g, [r.rid for r in c]) for b, g, c in j
    ]


@pytest.mark.parametrize("policy", [{}, {"cache_capacity": 1}],
                         ids=["unbounded", "capacity-1"])
def test_burst_stream_matches_jax(smoke, policy):
    cfg, tcfg, jparams, tparams = smoke
    jreqs = _traffic(jsched, cfg.vocab_size)
    treqs = _traffic(tsched, cfg.vocab_size)
    with jserve.Engine(cfg, jparams,
                       jserve.EngineConfig(**ENGINE, **policy)) as eng:
        jrep = jserve.run_burst_stream(eng, jreqs, clock=VirtualClock())
        jevict = eng._decode.cache.stats.evictions
    with Engine(tcfg, tparams, EngineConfig(**ENGINE, **policy),
                device="cpu") as eng:
        trep = run_burst_stream(eng, treqs, clock=VirtualClock())
        tevict = eng._decode.cache.stats.evictions
    assert tevict == jevict and (tevict > 0) == bool(policy)
    for key in ("finished", "tokens", "mode_switches", "compiles_total",
                "compiles_after_warmup", "rebinds"):
        assert trep[key] == jrep[key], key
    assert trep["engine"] == "burst" and trep["mode_switches"] >= 3
    assert not all(t.greedy for t in treqs)
    for j, t in zip(jreqs, treqs):
        assert len(t.tokens) == t.new_tokens
        assert t.tokens == j.tokens, t.rid


def test_set_mode_and_decode_loop_match_jax(smoke):
    cfg, tcfg, jparams, tparams = smoke
    first = np.array([[3], [17], [101], [250]], np.int32)
    with jserve.Engine(cfg, jparams, jserve.EngineConfig(**ENGINE)) as eng:
        eng.set_mode(batch=4, sampling=jserve.GREEDY)
        jtoks, _ = eng.decode_loop(jm.init_cache(cfg, 4, 32),
                                   jnp.asarray(first), 0, 6)
    with Engine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu") as eng:
        info = eng.set_mode(batch=3)  # rounds up to the 4-row bucket
        assert info["bucket"] == 4 and info["compiles"] == 1
        ttoks, _ = eng.decode_loop(models.init_cache(tcfg, 4, 32),
                                   torch.from_numpy(first), 0, 6)
        np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
        eng.set_mode(batch=4)  # same key: no build, no rebind
        assert eng._decode.stats.misses == 1 and eng._decode.stats.rebinds == 1
        assert eng.stats == {"tokens": 24, "hot_calls": 6, "mode_switches": 2}
        assert eng.telemetry.registry.snapshot()["counters"]


def test_prompt_then_burst_matches_jax(smoke):
    """prefill -> pad_cache -> set_mode + decode_loop from the prompt's end,
    the sequence of the JAX package's ``test_decode_multiple_steps_
    consistent``; the greedy tokens equal the JAX engine's and forward's
    argmax over prompt + tokens."""
    cfg, tcfg, jparams, tparams = smoke
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 8)).astype(np.int32)
    n = 6
    jl, jcache = jm.prefill(cfg, jparams, jnp.asarray(prompts))
    jfirst = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
    with jserve.Engine(cfg, jparams, jserve.EngineConfig(**ENGINE)) as eng:
        eng.set_mode(batch=4)
        jtoks, _ = eng.decode_loop(jax_pad_cache(cfg, jcache, 32), jfirst,
                                   8, n)
    tl, tcache = models.prefill(tcfg, tparams, torch.from_numpy(prompts))
    tfirst = tl.argmax(-1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    with Engine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu") as eng:
        eng.set_mode(batch=4)
        ttoks, _ = eng.decode_loop(models.pad_cache(tcfg, tcache, 32), tfirst,
                                   8, n)
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    seq = torch.cat([torch.from_numpy(prompts), tfirst,
                     torch.from_numpy(ttoks[:, :-1])], dim=1)
    logits, _ = models.forward(tcfg, tparams, seq)
    np.testing.assert_array_equal(logits[:, 8:].argmax(-1).numpy(), ttoks)


def test_sampled_burst_draws_from_the_generator(smoke):
    """A sampled burst draws from its ``rng`` key (zeros by default, as in
    the JAX package): the same key gives the same tokens, another key
    others, and each equals the JAX engine's ``decode_loop`` under that
    key."""
    cfg, tcfg, jparams, tparams = smoke
    first = np.array([[0], [5], [9], [200]], np.int32)
    keys = [None, np.array([7, 2**32 - 3], np.uint32),
            np.array([7, 2**32 - 3], np.uint32), np.array([1, 2], np.uint32)]
    with Engine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu") as eng:
        eng.set_mode(batch=4, sampling=1)
        runs = [eng.decode_loop(
            models.init_cache(tcfg, 4, 32), torch.from_numpy(first), 0, 8,
            rng=None if k is None else torch.from_numpy(k.view(np.int32)),
        )[0] for k in keys]
    assert runs[0].shape == (4, 8) and ((0 <= runs[0]) & (runs[0] < 256)).all()
    np.testing.assert_array_equal(runs[1], runs[2])
    assert (runs[1] != runs[3]).any() and (runs[0] != runs[1]).any()
    with jserve.Engine(cfg, jparams, jserve.EngineConfig(**ENGINE)) as eng:
        eng.set_mode(batch=4, sampling=jserve.SAMPLE)
        for k, toks in zip(keys[:2], runs[:2]):
            want, _ = eng.decode_loop(
                jm.init_cache(cfg, 4, 32), jnp.asarray(first), 0, 8,
                rng=None if k is None else jnp.asarray(k))
            np.testing.assert_array_equal(toks, np.asarray(want))


def test_hot_path_needs_the_cold_path_first(smoke):
    _, tcfg, _, tparams = smoke
    first = torch.zeros(4, 1, dtype=torch.int32)
    with Engine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu") as eng:
        with pytest.raises(DispatchError, match="set_mode"):
            eng.decode_loop(models.init_cache(tcfg, 4, 32), first, 0, 2)
        eng.set_mode(batch=4)
        toks, _ = eng.decode_loop(models.init_cache(tcfg, 4, 32), first, 0, 0)
        assert toks.shape == (4, 0)
        with pytest.raises(ValueError, match="tok: expected"):  # bucket guard
            eng.decode_loop(models.init_cache(tcfg, 8, 32),
                            torch.zeros(8, 1, dtype=torch.int32), 0, 1)


def test_launcher_burst_engine_and_its_guards(capsys):
    rep = launch.main(["--engine", "burst", "--smoke", "--device", "cpu",
                       "--requests", "6", "--max-len", "24", "--json"])
    assert rep["engine"] == "burst" and rep["finished"] == 6
    assert rep["compiles_after_warmup"] == rep["compiles_total"] >= 1
    for bad in (["--prompt-len", "8"], ["--spec-k", "2"],
                ["--kv-dtype", "int8"]):
        with pytest.raises(SystemExit):
            launch.main(["--engine", "burst", "--smoke", "--device", "cpu",
                         *bad])
    assert "requires --engine paged" in capsys.readouterr().err
