"""The port's ``perf`` knobs against the JAX package's.

``repro_torch.perf.PerfOpts`` has the JAX package's field names and
defaults. Under each knob of ``tests/test_perf_opts.py`` (chunked, chunked
with an 8-key block, bf16 scores, bf16 probabilities, bf16 norms; gemma2-27b
smoke in bf16, the JAX package's weights through ``params_from_jax``) the
port's ``forward(impl="auto")`` gives the JAX package's
``forward(impl="auto")`` logits under the same knob, within that file's
tolerance for the knob. Those tolerances exceed some knobs' own effect, so
each dtype knob is also held where it acts: ``_sdpa_naive``,
``_sdpa_chunked``, ``rms_norm`` and ``ln_nonparam`` under the knob and
without it, against the JAX package's on the same inputs, within a tenth of
the knob's effect there (which must be non-zero): a port that ignored the
knob would miss by all of it. ``attn_block`` is pinned by what it changes
that a reordered f32 sum does not hide: a key length it does not divide
raises. The attention kernels keep scores and probabilities in f32, so a sub-f32
``score_dtype``/``probs_dtype`` with them raises (``forward`` and an engine
at build). A serving target runs under the opts current when it was built.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import models, perf
from repro_torch.configs import get_config
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.serve import Engine, EngineConfig

# (opts, atol): tests/test_perf_opts.py's knobs and tolerances
KNOBS = {
    "naive": (perf.PerfOpts(), 5e-2),
    "chunked": (perf.PerfOpts(impl="chunked"), 5e-2),
    "chunked-small-block": (perf.PerfOpts(impl="chunked", attn_block=8), 5e-2),
    "score-bf16": (perf.PerfOpts(score_dtype="bfloat16"), 2e-1),
    "probs-bf16": (perf.PerfOpts(probs_dtype="bfloat16"), 5e-2),
    "norm-bf16": (perf.PerfOpts(norm_bf16=True), 2e-1),
}


def test_perf_opts_have_the_reference_fields_and_defaults():
    from repro import perf as jperf

    assert dataclasses.asdict(perf.PerfOpts()) == dataclasses.asdict(
        jperf.PerfOpts())
    kw = dict(impl="chunked", attn_block=8, score_dtype=None, norm_bf16=True)
    assert dataclasses.asdict(perf.from_flags(**kw)) == dataclasses.asdict(
        jperf.from_flags(**kw))
    assert perf.current() == perf.PerfOpts()
    opts = perf.PerfOpts(probs_dtype="bfloat16")
    with perf.use_perf_opts(opts):
        assert perf.current() is opts
    assert perf.current() == perf.PerfOpts()


@pytest.fixture(scope="module")
def bf16_model():
    jax = pytest.importorskip("jax")
    from repro import models as jm
    from repro.configs import get_config as jax_config
    from repro_torch.convert import params_from_jax

    jcfg = dataclasses.replace(jax_config("gemma2-27b").smoke(),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(get_config("gemma2-27b").smoke(),
                               dtype="bfloat16")
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    tok = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tok


@pytest.mark.parametrize("knob", list(KNOBS))
def test_knob_matches_jax_under_the_same_knob(bf16_model, knob):
    import jax.numpy as jnp
    from repro import models as jm
    from repro import perf as jperf

    jcfg, tcfg, jparams, tparams, tok = bf16_model
    opts, atol = KNOBS[knob]
    with jperf.use_perf_opts(jperf.PerfOpts(**dataclasses.asdict(opts))):
        jl, _ = jm.forward(jcfg, jparams, jnp.asarray(tok), impl="auto",
                           remat=False)
    with perf.use_perf_opts(opts):
        tl, _ = models.forward(tcfg, tparams, torch.from_numpy(tok),
                               impl="auto")
    assert tl.dtype == torch.float32 and torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                               atol=atol, rtol=0)


def _unit_inputs(dtype: str) -> dict:
    rng = np.random.default_rng(3)
    return {
        "q": rng.standard_normal((2, 32, 2, 2, 16)).astype(np.float32) * 2,
        "k": rng.standard_normal((2, 32, 2, 16)).astype(np.float32) * 2,
        "v": rng.standard_normal((2, 32, 2, 16)).astype(np.float32),
        "x": rng.standard_normal((2, 32, 64)).astype(np.float32) * 3,
        "scale": rng.standard_normal(64).astype(np.float32),
        "dtype": dtype,
    }


def _unit_jax(fn: str, opts, inp: dict) -> np.ndarray:
    import jax.numpy as jnp
    from repro import perf as jperf
    from repro.configs import get_config as jax_config
    from repro.models import attention as ja
    from repro.models import layers as jl

    cfg = jax_config("gemma2-27b").smoke()
    a = {n: jnp.asarray(inp[n], inp["dtype"]) for n in ("q", "k", "v", "x",
                                                         "scale")}
    with jperf.use_perf_opts(jperf.PerfOpts(**dataclasses.asdict(opts))):
        if fn == "rms_norm":
            out = jl.rms_norm(a["x"], a["scale"], cfg.norm_eps)
        elif fn == "ln_nonparam":
            out = jl.ln_nonparam(a["x"], cfg.norm_eps)
        elif fn == "_sdpa_chunked":
            out = ja._sdpa_chunked(cfg, a["q"], a["k"], a["v"], window=None,
                                   block=8)
        else:
            out = ja._sdpa_naive(cfg, a["q"], a["k"], a["v"],
                                 window=cfg.sliding_window)
    return np.asarray(out.astype(jnp.float32))


def _unit_port(fn: str, opts, inp: dict) -> np.ndarray:
    from repro_torch.models import attention as ta
    from repro_torch.models import layers as tl

    cfg = get_config("gemma2-27b").smoke()
    dt = getattr(torch, inp["dtype"])
    a = {n: torch.from_numpy(inp[n]).to(dt) for n in ("q", "k", "v", "x",
                                                       "scale")}
    with perf.use_perf_opts(opts):
        if fn == "rms_norm":
            out = tl.rms_norm(a["x"], a["scale"], cfg.norm_eps)
        elif fn == "ln_nonparam":
            out = tl.ln_nonparam(a["x"], cfg.norm_eps)
        elif fn == "_sdpa_chunked":
            out = ta._sdpa_chunked(cfg, a["q"], a["k"], a["v"], window=None,
                                   block=8)
        else:
            out = ta._sdpa_naive(cfg, a["q"], a["k"], a["v"],
                                 window=cfg.sliding_window)
    return out.float().numpy()


# (function, knob, input dtype): each dtype knob where the JAX package reads
# it and it changes the output (probs_dtype bf16 on bf16 operands rounds
# nothing more in _sdpa_naive, whose probabilities already take v's dtype)
UNIT_KNOBS = {
    "naive-score-bf16": ("_sdpa_naive", "score-bf16", "bfloat16"),
    "naive-score-bf16-f32-operands": ("_sdpa_naive", "score-bf16", "float32"),
    "naive-probs-bf16-f32-operands": ("_sdpa_naive", "probs-bf16", "float32"),
    "chunked-probs-bf16": ("_sdpa_chunked", "probs-bf16", "bfloat16"),
    "chunked-probs-bf16-f32-operands": ("_sdpa_chunked", "probs-bf16",
                                        "float32"),
    "rms-norm-bf16": ("rms_norm", "norm-bf16", "bfloat16"),
    "ln-nonparam-norm-bf16": ("ln_nonparam", "norm-bf16", "bfloat16"),
}


@pytest.mark.parametrize("case", list(UNIT_KNOBS))
def test_knob_moves_the_port_as_it_moves_jax(case):
    """Where the knob acts, the port under it and without it equals the
    JAX package's within a tenth of what the knob changes there."""
    pytest.importorskip("jax")
    fn, knob, dtype = UNIT_KNOBS[case]
    opts = KNOBS[knob][0]
    inp = _unit_inputs(dtype)
    jbase, jknob = _unit_jax(fn, perf.PerfOpts(), inp), _unit_jax(fn, opts,
                                                                  inp)
    effect = float(np.abs(jknob - jbase).max())
    assert effect > 0, f"{knob} changes nothing in the JAX {fn}"
    tol = 0.1 * effect
    np.testing.assert_allclose(_unit_port(fn, perf.PerfOpts(), inp), jbase,
                               atol=tol, rtol=0)
    np.testing.assert_allclose(_unit_port(fn, opts, inp), jknob, atol=tol,
                               rtol=0)


def test_attn_block_is_the_chunked_key_block():
    """``attn_block`` is the key block of ``impl="chunked"``: 12 keys run
    in blocks of 4 (equal to naive in f32) and raise in blocks of 8, as
    the JAX package asserts."""
    cfg = get_config("gemma2-27b").smoke()
    params = models.init_params(cfg, seed=0)
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 12)).astype(np.int32))
    want, _ = models.forward(cfg, params, tok, impl="naive")
    with perf.use_perf_opts(perf.PerfOpts(impl="chunked", attn_block=4)):
        got, _ = models.forward(cfg, params, tok, impl="auto")
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    with perf.use_perf_opts(perf.PerfOpts(impl="chunked", attn_block=8)):
        with pytest.raises(ValueError, match="not a multiple of block 8"):
            models.forward(cfg, params, tok, impl="auto")


def test_seq_shard_fallback_is_read_by_the_mesh_prefill():
    """Every field has its reader: ``seq_shard_fallback=True`` is accepted
    and changes the collectives of a mesh's prefill where the heads do not
    divide ``model`` (qwen3 smoke, 4 heads, on a 1 x 8 ``meta`` mesh): each
    layer's keys and query rows joined over ``model`` by an all-gather
    (``[B, S, KH, dh]`` and ``[B, S, D]`` float32) that the unflagged step
    does not make; the all-reduces stay, the flops fall."""
    from repro_torch import capture_analysis
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import mesh as tmesh
    from repro_torch.runtime import steps

    assert not hasattr(perf, "UNREAD")
    assert perf.from_flags(seq_shard_fallback=True).seq_shard_fallback
    cfg = get_config("qwen3-14b").smoke()
    mesh = tmesh.make_debug_mesh((1, 8), ("data", "model"),
                                 devices=["meta"] * 8)
    b, s = 8, 32
    reps = []
    for fb in (False, True):
        low = steps.lower_for(cfg, mesh, ShapeSpec("p", "prefill", s, b),
                              opts=perf.PerfOpts(seq_shard_fallback=fb))
        reps.append(capture_analysis.analyze_step(
            low.compile(), low.args, mesh=mesh, arg_specs=low.arg_specs))
    off, on = reps
    row = b * s * (cfg.num_kv_heads * cfg.head_dim + cfg.d_model) * 4
    assert (on["collectives"].get("all-gather", 0)
            - off["collectives"].get("all-gather", 0)) == cfg.num_layers * row
    assert on["collectives"]["all-reduce"] == off["collectives"]["all-reduce"]
    assert on["flops"] < off["flops"] / 2


def test_auto_resolves_to_the_opts_impl():
    """``impl="auto"`` is ``perf.current().impl`` (fp32 smoke: equal)."""
    cfg = get_config("gemma2-27b").smoke()
    params = models.init_params(cfg, seed=0)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 24)).astype(np.int32))
    for impl in ("naive", "chunked", "kernel"):
        want, _ = models.forward(cfg, params, tok, impl=impl)
        with perf.use_perf_opts(perf.PerfOpts(impl=impl)):
            got, _ = models.forward(cfg, params, tok, impl="auto")
        torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("field", ["score_dtype", "probs_dtype"])
def test_kernels_refuse_sub_f32_scores(field):
    """``impl="kernel"`` and engines with ``attn_impl="kernel"`` raise at
    build under a sub-f32 score or probability dtype; ``attn_impl="plain"``
    builds (its per-row attention has no such knob, as the JAX package's)."""
    cfg = get_config("olmo-1b").smoke()
    params = models.init_params(cfg, seed=0)
    tok = torch.zeros(1, 8, dtype=torch.int32)
    ecfg = dict(max_len=32, max_batch=2, page_size=8, prefill_chunk=8)
    with perf.use_perf_opts(perf.PerfOpts(**{field: "bfloat16"})):
        with pytest.raises(ValueError, match=field):
            models.forward(cfg, params, tok, impl="kernel")
        models.forward(cfg, params, tok, impl="naive")
        with Engine(cfg, params, EngineConfig(**ecfg), device="cpu") as eng:
            with pytest.raises(ValueError, match="float32"):
                eng.paged_continuous(slots=2)
        with Engine(cfg, params, EngineConfig(**ecfg), device="cpu") as eng:
            with pytest.raises(ValueError, match="attn_impl='kernel'"):
                eng.set_mode(batch=2)
        with Engine(cfg, params, EngineConfig(**ecfg, attn_impl="plain"),
                    device="cpu") as eng:
            assert eng.paged_continuous(slots=2).num_slots == 2


def test_a_target_keeps_the_opts_it_was_built_under(monkeypatch):
    """A ``cb`` target built under ``norm_bf16`` runs under it after the
    context has exited, and under nothing else the caller sets later."""
    seen = []
    make = steps_mod.make_slot_decode_fn

    def spying(*args, **kwargs):
        step = make(*args, **kwargs)

        def spy(*a, **k):
            seen.append(perf.current())
            return step(*a, **k)

        return spy

    monkeypatch.setattr(steps_mod, "make_slot_decode_fn", spying)
    cfg = get_config("olmo-1b").smoke()
    params = models.init_params(cfg, seed=0)
    built = perf.PerfOpts(norm_bf16=True)
    with Engine(cfg, params, EngineConfig(max_len=32, max_batch=2),
                device="cpu") as eng:
        with perf.use_perf_opts(built):
            cb = eng.continuous(slots=2)
        assert seen and all(o is built for o in seen)
        seen.clear()
        with perf.use_perf_opts(perf.PerfOpts(impl="chunked")):
            from repro_torch.runtime.scheduler import Request

            cb.admit([Request(rid=0, new_tokens=3, prompt=(1, 2))])
            while cb.has_work:
                cb.step()
    assert seen and all(o is built for o in seen)
