"""The port's Mamba-2 (SSM) slice against the JAX package: kernel B8's plain
version and ``ssd_scan``, the mixer, ``mamba2-370m``'s smoke config through
``forward``/``prefill``/``pad_cache``/``decode_step``, and the per-burst
engine on the recurrent state.

Inputs come from numpy seeds and weights from the JAX package's
``init_params``/``ssm_init`` (``params_from_jax``), so both sides compute on
the same numbers. Tolerances:

- B8 and ``ssd_scan`` in fp32: 2e-5, ``tests/test_kernels.py``'s own (fp32
  on both sides, summed in another order); bf16: 5e-2, its bf16 test's.
- The mixer and the model in fp32: 1e-5 on mixer outputs and caches, 1e-4 on
  logits (``test_torch_model.py``'s): the same fp32 arithmetic through two
  frameworks' products and exponentials.
- The mixer in bf16: both round at the same points (conv, ``y + x·D`` and
  the gate in bf16; decode's y in fp32, cast once), but each framework
  rounds its own fp32 intermediates to bf16, so single elements land a bf16
  step or two apart (2^-8 relative each) and carry that through the norm
  and the output product; the fp32 state sums such inputs -> 2e-2 relative
  to the largest |output| or |state| for both.

The token streams of the burst engine must be equal, sampled bursts too
(threefry keys in both packages), as must its cold-path counters, under
one virtual clock (``test_torch_burst.py``'s harness).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_burst import ENGINE, VirtualClock, _traffic

from repro import models as jm
from repro.configs import get_config as jax_config
from repro.kernels import ssd_chunk as jax_ssd_chunk
from repro.models import ssm as jssm
from repro.models.model import pad_cache as jax_pad_cache
from repro.runtime import scheduler as jsched
from repro.runtime import serve as jserve
from repro_torch import kernels, models
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch
from repro_torch.models import blocks
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime.serve import Engine, EngineConfig, run_burst_stream

TOL = 2e-5
BF16_TOL = 5e-2
MIXER_TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_MIXER_REL = 2e-2
BF16_STATE_REL = 2e-2
ARCH = "mamba2-370m"


def _cfgs(**over):
    return (dataclasses.replace(jax_config(ARCH).smoke(), **over),
            dataclasses.replace(get_config(ARCH).smoke(), **over))


def _ssd_inputs(seq: int, groups: int, *, seed: int):
    """x [B,S,H,P], B/C [B,S,G,N] (G = H: per head; G = 1: one group),
    dt after softplus, A negative — numpy float32."""
    cfg = get_config(ARCH).smoke()
    rng = np.random.default_rng(seed)
    b, h, p, n = 2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    x = rng.standard_normal((b, seq, h, p)).astype(np.float32)
    bm = (rng.standard_normal((b, seq, groups, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, seq, groups, n)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, seq, h)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    return x, bm, cm, dt, a


def _jax_expand(t: np.ndarray, heads: int) -> jax.Array:
    return jnp.repeat(jnp.asarray(t), heads // t.shape[2], axis=2)


def _torch_ssd(x, bm, cm, dt, a, **kw):
    """The B8 wrapper on CPU tensors; B/C as the mixer passes them (one
    group as a stride-0 view over the heads)."""
    h = x.shape[2]
    b_, c_ = (torch.from_numpy(t) for t in (bm, cm))
    if b_.shape[2] == 1:
        b_, c_ = (t.expand(-1, -1, h, -1) for t in (b_, c_))
    y, s = kernels.ssd_chunk(torch.from_numpy(x), b_, c_,
                             torch.from_numpy(dt), torch.from_numpy(a), **kw)
    return y.numpy(), s.numpy()


# ---------------------------------------------------------------- kernel B8
@pytest.mark.parametrize("groups", [1, 8], ids=["one-group", "per-head"])
@pytest.mark.parametrize("seq", [16, 32])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_plain_matches_pallas_and_scan(chunk, seq, groups):
    """As ``tests/test_kernels.py:test_ssd_kernel_matches_scan_oracle``:
    the wrapper's plain version (B8 on CPU tensors) and the port's
    ``ssd_scan`` against the Pallas kernel in interpret mode and JAX
    ``ssd_scan``."""
    jcfg, tcfg = _cfgs(ssm_chunk=chunk)
    x, bm, cm, dt, a = _ssd_inputs(seq, groups, seed=chunk * 100 + seq)
    h = x.shape[2]
    jargs = (jnp.asarray(x), _jax_expand(bm, h), _jax_expand(cm, h),
             jnp.asarray(dt), jnp.asarray(a))
    y_ref, s_ref = jssm.ssd_scan(jcfg, *jargs)
    y_pl, s_pl = jax_ssd_chunk(*jargs, chunk=chunk, interpret=True)
    y, s = _torch_ssd(x, bm, cm, dt, a, chunk=chunk)
    for want in ((y_ref, s_ref), (y_pl, s_pl)):
        np.testing.assert_allclose(y, np.asarray(want[0]), atol=TOL, rtol=0)
        np.testing.assert_allclose(s, np.asarray(want[1]), atol=TOL, rtol=0)
    ty, ts = models.ssd_scan(tcfg, *(torch.from_numpy(np.array(t))
                                     for t in jargs))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y_ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(s_ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("seq", [5, 20])
def test_ssd_plain_takes_ragged_lengths(seq):
    """S not a multiple of the chunk (and S < chunk): B8's plain version
    masks the tail as ``dt = 0`` rows, which is ``ssd_scan``'s padding."""
    jcfg, tcfg = _cfgs(ssm_chunk=8)
    x, bm, cm, dt, a = _ssd_inputs(seq, 1, seed=seq)
    h = x.shape[2]
    jargs = (jnp.asarray(x), _jax_expand(bm, h), _jax_expand(cm, h),
             jnp.asarray(dt), jnp.asarray(a))
    y_ref, s_ref = jssm.ssd_scan(jcfg, *jargs)
    y, s = _torch_ssd(x, bm, cm, dt, a, chunk=8)
    assert y.shape == x.shape
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(s, np.asarray(s_ref), atol=TOL, rtol=0)
    ty, ts = models.ssd_scan(tcfg, *(torch.from_numpy(np.array(t))
                                     for t in jargs))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y_ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(s_ref), atol=TOL, rtol=0)


def test_ssd_plain_bf16_matches_pallas():
    """As ``test_kernels.py:test_ssd_kernel_bf16``: bf16 x, B, C; 5e-2."""
    x, bm, cm, dt, a = _ssd_inputs(16, 8, seed=9)
    bf = jnp.bfloat16
    jy, js = jax_ssd_chunk(jnp.asarray(x, bf), jnp.asarray(bm, bf),
                           jnp.asarray(cm, bf), jnp.asarray(dt),
                           jnp.asarray(a), chunk=8, interpret=True)
    ty, ts = kernels.ssd_chunk(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (x, bm, cm)),
        torch.from_numpy(dt), torch.from_numpy(a), chunk=8)
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.float32
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), atol=BF16_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=BF16_TOL)


def test_ssd_scan_carries_an_initial_state():
    jcfg, tcfg = _cfgs()
    x, bm, cm, dt, a = _ssd_inputs(20, 8, seed=3)
    h0 = np.random.default_rng(4).standard_normal(
        (2, x.shape[2], x.shape[3], bm.shape[-1])).astype(np.float32)
    args = (x, bm, cm, dt, a, h0)
    jy, js = jssm.ssd_scan(jcfg, *(jnp.asarray(t) for t in args))
    ty, ts = models.ssd_scan(tcfg, *(torch.from_numpy(t) for t in args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL, rtol=0)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    """Also at a (chunk, P, N) with no CUDA instantiation: the CPU path is
    the plain version whatever the shape."""
    x, bm, cm, dt, a = (torch.from_numpy(t)
                        for t in _ssd_inputs(12, 8, seed=5))
    before = kernels.ssd_chunk.launches
    for chunk in (8, 5):
        y, s = kernels.ssd_chunk(x, bm, cm, dt, a, chunk=chunk)
        ry, rs = kernels.ssd_chunk_plain(x, bm, cm, dt, a, chunk=chunk)
        torch.testing.assert_close(y, ry, atol=0, rtol=0)
        torch.testing.assert_close(s, rs, atol=0, rtol=0)
    assert kernels.ssd_chunk.launches == before


# -------------------------------------------------------------- the mixer
def _mixer(dtype: str):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp = jssm.ssm_init(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(2).standard_normal(
        (2, 11, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _close(t: torch.Tensor, j, rel: float | None, err_msg: str = "") -> None:
    want = np.asarray(j, np.float32)
    got = t.float().numpy()
    if rel is None:
        np.testing.assert_allclose(got, want, atol=MIXER_TOL, rtol=0,
                                   err_msg=err_msg)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= rel, (err_msg, err)


@pytest.mark.parametrize("impl", ["kernel", "naive"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_apply_and_decode_steps_match_jax(dtype, impl):
    """One mixer: ``ssm_apply`` with its cache (the *pre-conv* xBC tail and
    the final state), then three ``ssm_decode_step`` tokens from it."""
    jcfg, tcfg, jp, tp, x = _mixer(dtype)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    rel, srel = (None, None) if dtype == "float32" else (
        BF16_MIXER_REL, BF16_STATE_REL)
    prompt = 8
    jy, jc = jssm.ssm_apply(jcfg, jp, jnp.asarray(x[:, :prompt], jdt),
                            return_cache=True)
    ty, tc = models.ssm_apply(tcfg, tp, torch.from_numpy(
        x[:, :prompt]).to(tdt), return_cache=True, impl=impl)
    assert ty.dtype == tdt and tc["state"].dtype == torch.float32
    assert tc["conv"].shape == (2, tcfg.conv_kernel - 1,
                                tcfg.ssm_d_inner + 2 * tcfg.ssm_state)
    _close(ty, jy, rel, "y")
    _close(tc["conv"], jc["conv"], rel, "conv")
    _close(tc["state"], jc["state"], srel, "state")
    for i in range(prompt, x.shape[1]):
        jy, jc = jssm.ssm_decode_step(jcfg, jp, jnp.asarray(x[:, i:i + 1], jdt),
                                      jc)
        ty, tc2 = models.ssm_decode_step(
            tcfg, tp, torch.from_numpy(x[:, i:i + 1]).to(tdt), tc)
        assert tc2 is tc  # updated in place
        _close(ty, jy, rel, f"decode y at {i}")
        _close(tc["conv"], jc["conv"], rel, f"conv at {i}")
        _close(tc["state"], jc["state"], srel, f"state at {i}")


def test_ssm_apply_with_kernel_refuses_an_initial_state():
    _, tcfg, _, tp, x = _mixer("float32")
    h0 = torch.zeros(2, tcfg.ssm_heads, tcfg.ssm_headdim, tcfg.ssm_state)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="zero state"):
        models.ssm_apply(tcfg, tp, xt, h0, impl="kernel")
    y, h = models.ssm_apply(tcfg, tp, xt, h0, impl="naive")
    assert y.shape == xt.shape and h.shape == h0.shape


# --------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = _cfgs()
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    tok = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 13)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tok


@pytest.mark.parametrize("impl", models.FULL_IMPLS)
def test_forward_matches_jax(smoke, impl):
    """13 tokens, chunk 8: a ragged second chunk."""
    jcfg, tcfg, jparams, tparams, tok = smoke
    jl, _ = jm.forward(jcfg, jparams, jnp.asarray(tok), remat=False)
    tl, aux = models.forward(tcfg, tparams, torch.from_numpy(tok), impl=impl)
    assert tl.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)


def test_prefill_pad_cache_then_decode_match_jax(smoke):
    jcfg, tcfg, jparams, tparams, tok = smoke
    prompt, total = 9, tok.shape[1]
    jl, jcache = jm.prefill(jcfg, jparams, jnp.asarray(tok[:, :prompt]))
    tl, tcache = models.prefill(tcfg, tparams,
                                torch.from_numpy(tok[:, :prompt]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    m = tcfg.num_layers
    assert tcache[0]["conv"].shape == (m, 2, 3, 160)
    assert tcache[0]["state"].shape == (m, 2, 8, 16, 16)

    def caches_close():
        for name, t in tcache[0].items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jcache[0][name]),
                                       atol=MIXER_TOL, rtol=0, err_msg=name)

    caches_close()
    jcache = jax_pad_cache(jcfg, jcache, 32)
    tcache = models.pad_cache(tcfg, tcache, 32)
    for pos in range(prompt, total):
        jl, jcache = jm.decode_step(jcfg, jparams, jcache,
                                    jnp.asarray(tok[:, pos:pos + 1]),
                                    jnp.int32(pos))
        tl, tcache = models.decode_step(
            tcfg, tparams, tcache, torch.from_numpy(tok[:, pos:pos + 1]),
            torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0, err_msg=str(pos))
    caches_close()


def test_pad_cache_leaves_ssm_slots_unchanged(smoke):
    _, tcfg, _, tparams, tok = smoke
    _, cache = models.prefill(tcfg, tparams, torch.from_numpy(tok))
    before = {k: t.clone() for k, t in cache[0].items()}
    padded = models.pad_cache(tcfg, cache, 64)
    assert padded[0] is cache[0]
    for k, t in padded[0].items():
        assert t is cache[0][k]
        torch.testing.assert_close(t, before[k], atol=0, rtol=0)


def test_decode_matches_forward_last_token(smoke):
    """Prefill S-1 tokens, one decode step = forward's last position."""
    _, tcfg, _, tparams, tok = smoke
    t = torch.from_numpy(tok)
    full, _ = models.forward(tcfg, tparams, t)
    _, cache = models.prefill(tcfg, tparams, t[:, :-1])
    last, _ = models.decode_step(tcfg, tparams, models.pad_cache(
        tcfg, cache, 32), t[:, -1:], torch.tensor(12, dtype=torch.int32))
    torch.testing.assert_close(last, full[:, -1], atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_jax_layout(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jshapes = {
        k: (tuple(v.shape), str(v.dtype))
        for k, v in params_from_jax(jax.tree.map(
            np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))).items()
    }
    tshapes = {k: (tuple(v.shape), str(v.dtype))
               for k, v in models.init_params(tcfg, seed=0).items()}
    assert tshapes == jshapes
    assert "blocks.0.ssm.wz" in tshapes and "head.lm_head" not in tshapes


def test_params_from_jax_keeps_f32_ssm_leaves_beside_bf16():
    jcfg, _ = _cfgs(dtype="bfloat16")
    t = params_from_jax(jax.tree.map(
        np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0))))
    for leaf in ("A_log", "D", "dt_bias"):
        assert t[f"blocks.0.ssm.{leaf}"].dtype == torch.float32, leaf
    for leaf in ("wz", "wx", "wB", "wC", "wdt", "conv", "norm_scale", "out"):
        assert t[f"blocks.0.ssm.{leaf}"].dtype == torch.bfloat16, leaf
    torch.testing.assert_close(t["blocks.0.ssm.D"],
                               torch.ones_like(t["blocks.0.ssm.D"]))


def test_init_params_draws_ssm_init_scales():
    _, tcfg = _cfgs()
    p = models.init_params(tcfg, seed=0)
    d = tcfg.d_model
    assert abs(float(p["blocks.0.ssm.wz"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(p["blocks.0.ssm.conv"].std()) - 0.1) < 0.02
    for leaf, val in (("A_log", 0.0), ("dt_bias", 0.0), ("D", 1.0),
                      ("norm_scale", 0.0)):
        assert (p[f"blocks.0.ssm.{leaf}"] == val).all(), leaf


def test_dense_cache_of_an_ssm_stack_refuses_int8():
    _, tcfg = _cfgs()
    cache = models.init_cache(tcfg, 3, 64)
    assert set(cache[0]) == {"conv", "state"}
    assert cache[0]["state"].dtype == torch.float32
    with pytest.raises(ValueError, match="quantised dense KV is attention-only"):
        models.init_cache(tcfg, 3, 64, "int8")


@pytest.mark.parametrize("entry", ["paged_decode", "paged_prefill",
                                   "chunk_decode", "paged_cache"])
def test_paged_and_chunk_entry_points_refuse_ssm_slots(smoke, entry):
    _, tcfg, _, tparams, _ = smoke
    x = torch.zeros(2, 1, tcfg.d_model)
    z = torch.zeros(2, dtype=torch.int32)
    p = models.layer_params(tparams, 0, 0)
    calls = {
        "paged_decode": (lambda: blocks.block_paged_decode(
            tcfg, 0, p, x, {}, z, z[:, None]), "paged decode is attention"),
        "paged_prefill": (lambda: blocks.block_paged_prefill(
            tcfg, 0, p, x, {}, z, z[:, None], z), "paged prefill is attention"),
        "chunk_decode": (lambda: blocks.block_chunk_decode(
            tcfg, 0, p, x, {}, z, z), "teacher-force SSM stacks"),
        "paged_cache": (lambda: models.init_paged_cache(tcfg, 8, 8),
                        "the paged KV path supports attention-only stacks"),
    }
    fn, match = calls[entry]
    with pytest.raises(ValueError, match=match):
        fn()


# -------------------------------------------------------------- the engine
@pytest.fixture(scope="module")
def engines(smoke):
    return smoke[:4]


def test_burst_stream_matches_jax(engines):
    jcfg, tcfg, jparams, tparams = engines
    jreqs = _traffic(jsched, jcfg.vocab_size)
    treqs = _traffic(tsched, jcfg.vocab_size)
    with jserve.Engine(jcfg, jparams, jserve.EngineConfig(**ENGINE)) as eng:
        jrep = jserve.run_burst_stream(eng, jreqs, clock=VirtualClock())
    with Engine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu") as eng:
        trep = run_burst_stream(eng, treqs, clock=VirtualClock())
    for key in ("finished", "tokens", "mode_switches", "compiles_total",
                "compiles_after_warmup", "rebinds"):
        assert trep[key] == jrep[key], key
    assert trep["mode_switches"] >= 3 and trep["compiles_after_warmup"] >= 2
    assert not all(t.greedy for t in treqs)
    for j, t in zip(jreqs, treqs):
        assert len(t.tokens) == t.new_tokens
        assert t.tokens == j.tokens, t.rid  # sampled bursts too (threefry)


def test_prompt_then_burst_matches_jax(engines):
    """prefill -> pad_cache -> set_mode + decode_loop on the recurrent
    state: the greedy tokens equal the JAX engine's and forward's argmax."""
    jcfg, tcfg, jparams, tparams = engines
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (4, 10)).astype(np.int32)
    n = 6
    jl, jcache = jm.prefill(jcfg, jparams, jnp.asarray(prompts))
    jfirst = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
    with jserve.Engine(jcfg, jparams, jserve.EngineConfig(**ENGINE)) as eng:
        eng.set_mode(batch=4)
        jtoks, _ = eng.decode_loop(jax_pad_cache(jcfg, jcache, 32), jfirst,
                                   10, n)
    tl, tcache = models.prefill(tcfg, tparams, torch.from_numpy(prompts))
    tfirst = tl.argmax(-1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    with Engine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu") as eng:
        eng.set_mode(batch=4)
        ttoks, _ = eng.decode_loop(models.pad_cache(tcfg, tcache, 32), tfirst,
                                   10, n)
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    seq = torch.cat([torch.from_numpy(prompts), tfirst,
                     torch.from_numpy(ttoks[:, :-1])], dim=1)
    logits, _ = models.forward(tcfg, tparams, seq)
    np.testing.assert_array_equal(logits[:, 10:].argmax(-1).numpy(), ttoks)


def test_paged_engine_and_launcher_refuse_an_ssm_arch(engines, capsys):
    _, tcfg, _, tparams = engines
    with Engine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu") as eng:
        with pytest.raises(ValueError, match="has recurrent state; the paged"):
            eng.paged_continuous()
    with pytest.raises(SystemExit):
        launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--engine", "paged"])
    assert "attention-only stacks" in capsys.readouterr().err


def test_launcher_serves_mamba_through_the_burst_engine():
    rep = launch.main(["--arch", ARCH, "--engine", "burst", "--smoke",
                       "--device", "cpu", "--requests", "6", "--max-len",
                       "24", "--json"])
    assert rep["engine"] == "burst" and rep["finished"] == 6
    assert rep["compiles_after_warmup"] == rep["compiles_total"] >= 1
