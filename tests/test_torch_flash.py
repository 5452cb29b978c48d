"""Kernels B5 (dense decode), B6 (specialised flash) and B7 (runtime-flag
flash) of the port against the JAX package, and the full-sequence model path
(``forward``, ``prefill``, scalar-position ``decode_step``) that runs them.

Kernels: the plain versions (what the wrappers run on CPU tensors) against
the Pallas kernels in interpret mode and the ``ref.py`` oracles, over every
mode (causal, window, softcap on and off; B7 takes them as flags), head
layouts 4/2 and 8/8, fp32 inputs from a numpy seed. Tolerance atol 2e-5,
``tests/test_kernels.py``'s own: fp32 on both sides, summed in another
order. The CUDA kernels against their plain versions, and the wrappers'
CPU/CUDA split, are in ``test_torch_kernels.py`` (which runs on a card
without JAX).

Models: ``olmo-1b``'s smoke config (fp32) and a variant with local/global
layers, a sliding window and both softcaps, on the JAX package's weights
(``params_from_jax``). Logits atol 1e-4 (``test_torch_model.py``'s), prefill
caches atol 1e-5.
"""

from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_config as jax_config
from repro.models.model import pad_cache as jax_pad_cache
from repro_torch import kernels, models
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import KernelBranch
from repro_torch.kernels.decode_attention import NEG_INF

TOL = 2e-5
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
LAYOUTS = ((4, 2), (8, 8))  # (heads, kv heads)
FLASH_MODES = [
    (causal, window, softcap)
    for causal in (True, False)
    for window in (None, 24)
    for softcap in (None, 3.0)
]
DECODE_MODES = [(None, None), (24, None), (None, 3.0), (24, 3.0)]
BLOCK = 32  # Pallas tiles: 64-long sequences give 2 x 2 tile grids


@pytest.fixture(scope="module")
def jk():
    """The JAX package's Pallas kernel modules and oracles."""
    return (
        importlib.import_module("repro.kernels.flash_attention"),
        importlib.import_module("repro.kernels.decode_attention"),
        importlib.import_module("repro.kernels.ref"),
    )


def _qkv(heads, kv_heads, *, seq=64, dh=16, seed=0, decode=False):
    rng = np.random.default_rng(seed)
    b = 2
    q_shape = (b, heads, dh) if decode else (b, heads, seq, dh)
    return (
        rng.standard_normal(q_shape).astype(np.float32),
        rng.standard_normal((b, kv_heads, seq, dh)).astype(np.float32),
        rng.standard_normal((b, kv_heads, seq, dh)).astype(np.float32),
    )


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _flags(causal, window, softcap) -> np.ndarray:
    return np.array([int(causal), window or 0, int(softcap or 0)], np.int32)


# ------------------------------------------------------------- B6 and B7
@pytest.mark.parametrize("causal,window,softcap", FLASH_MODES)
@pytest.mark.parametrize("heads,kv_heads", LAYOUTS)
def test_flash_plain_matches_pallas_and_reference(
    jk, heads, kv_heads, causal, window, softcap
):
    jfa, _, jref = jk
    q, k, v = _qkv(heads, kv_heads, seed=heads + 3 * (window or 1))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = kernels.flash_attention(*_t(q, k, v), **kw).numpy()
    pallas = jfa.flash_attention(
        *_j(q, k, v), block_q=BLOCK, block_k=BLOCK, interpret=True, **kw
    )
    ref = jref.attention_ref(*_j(q, k, v), **kw)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=TOL, rtol=0)
    np.testing.assert_allclose(out, np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("causal,window,softcap", FLASH_MODES)
@pytest.mark.parametrize("heads,kv_heads", LAYOUTS)
def test_branchy_plain_matches_pallas_and_specialised(
    jk, heads, kv_heads, causal, window, softcap
):
    """B7 takes the mode as flags (an integer cap) and computes what the
    Pallas branchy kernel and B6 in the same mode compute."""
    jfa, _, _ = jk
    q, k, v = _qkv(heads, kv_heads, seed=heads + 7 * (window or 1))
    flags = _flags(causal, window, softcap)
    out = kernels.flash_attention_branchy(*_t(q, k, v, flags)).numpy()
    pallas = jfa.flash_attention_branchy(
        *_j(q, k, v, flags), block_q=BLOCK, block_k=BLOCK, interpret=True
    )
    spec = kernels.flash_attention(
        *_t(q, k, v), causal=causal, window=window, softcap=softcap
    ).numpy()
    np.testing.assert_allclose(out, np.asarray(pallas), atol=TOL, rtol=0)
    np.testing.assert_allclose(out, spec, atol=TOL, rtol=0)


@pytest.mark.parametrize("seq", [37, 100])
def test_flash_takes_strided_views_and_ragged_lengths(seq):
    """The model feeds [B, S, H, dh] activations as transposed views; prompt
    lengths are free (no multiple of a tile)."""
    q, k, v = _qkv(4, 2, seq=seq, seed=seq)
    contiguous = kernels.flash_attention(*_t(q, k, v), window=16)
    views = [torch.from_numpy(a).transpose(1, 2).contiguous().transpose(1, 2)
             for a in (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(
        kernels.flash_attention(*views, window=16), contiguous,
        atol=0, rtol=0,
    )


# ------------------------------ B6/B7's tensor-core body (bf16, 64 and 128)
# chip_smoke.py's KERNEL_ATOL[bf16], the kernels' tolerance on the card
BF16_KERNEL_ATOL = 2e-2
TC_MODES = [
    (causal, window, softcap)
    for causal in (True, False)
    for window in (None, 256)
    for softcap in (None, 50.0)
]


def _tensor_core_rounding(q, k, v, *, causal, window, softcap, tile=128):
    """The tensor-core body's arithmetic in PyTorch: bf16 q/k/v, fp32 scores
    and online softmax over 128-key tiles (exp2 of logits scaled by log2 e),
    the probabilities P rounded to bf16 for P V with fp32 accumulation, the
    denominator summed from the unrounded P, the output rounded to bf16.
    The hardware's approximate exp2 and tanh (relative errors near 2^-22
    and 2^-11) are left to the card's checks."""
    b, h, sq, dh = q.shape
    kh, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kh, h // kh, sq, dh).float()
    m = torch.full((b, kh, h // kh, sq), NEG_INF)
    l = torch.zeros_like(m)
    o = torch.zeros(b, kh, h // kh, sq, dh)
    qi = torch.arange(sq)[:, None]
    for k0 in range(0, sk, tile):
        kt, vt = (t[:, :, k0 : k0 + tile].float() for t in (k, v))
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kt) * (1.0 / dh**0.5)
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        ki = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones(sq, kt.shape[2], dtype=torch.bool)
        if causal:
            ok &= ki <= qi
        if window is not None:
            ok &= ki > qi - window
        x = torch.where(ok, s * 1.4426950408889634, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1))
        p = torch.exp2(x - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.bfloat16().float(), vt)
        m = m_new
    o = o / l.clamp_min(1e-37)[..., None]
    return o.reshape(b, h, sq, dh).bfloat16()


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal,window,softcap", TC_MODES)
def test_tensor_core_rounding_stays_within_the_bf16_tolerance(
    causal, window, softcap, dh
):
    """P rounded to bf16 before P V is the one rounding the tensor-core body
    adds; at 1 x 1024 tokens, 2 heads of 64 or 128 (both instantiations), it
    keeps the output within the card's bf16 tolerance of the fp32 plain
    version (by design, on the CPU)."""
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 1024, dh)).astype(
        np.float32)).bfloat16() for _ in range(3))
    kw = dict(causal=causal, window=window, softcap=softcap)
    emulated = _tensor_core_rounding(q, k, v, **kw).float()
    plain = kernels.flash_attention_plain(q.float(), k.float(), v.float(),
                                          **kw)
    err = (emulated - plain).abs().max().item()
    assert 0 < err <= BF16_KERNEL_ATOL


def _entry_routes(src: str, entry: str) -> dict:
    """{(dtype code, head_dim): launcher} of one C entry point."""
    import re

    body = src.split(f'extern "C" int {entry}(')[1].split("\n}\n")[0]
    return {(int(d), int(hd)): fn for d, hd, fn in re.findall(
        r"if \(dtype == (\d) && head_dim == (\d+)\) return (\w+)", body)}


@pytest.mark.parametrize("entry", ["flash_attention",
                                   "flash_attention_branchy"])
def test_flash_entry_points_route_bf16_128_to_tensor_cores(entry):
    """Both C entry points send bf16 (code 1) at head_dim 64 and 128 to the
    tensor-core body and fp32 or head_dim 16 to the CUDA-core body, for
    every dtype and head_dim the wrappers accept; the tensor-core body runs
    both products as wgmma and loads its tiles with TMA."""
    from repro_torch.kernels import build

    src = (build.CSRC / "flash_attention.cu").read_text()
    routes = _entry_routes(src, entry)
    assert set(routes) == build.instantiated()
    assert {(1, 64), (1, 128)} <= set(routes)
    suffix = "_branchy" if entry.endswith("branchy") else ""
    for key, fn in routes.items():
        body = ("launch_tensor_cores" if key in ((1, 64), (1, 128))
                else "launch_cuda_cores")
        assert fn == body + suffix, (key, fn)
    tc = src.split("__device__ void flash_tc_block(")[1].split("\n}\n")[0]
    for call in ("wgmma_ss(", "wgmma_rs(", "tma_load_4d(", "mbar_wait("):
        assert call in tc
    assert "flash_block_simt" not in tc


def test_every_header_is_hashed_into_the_libraries():
    """A header missing from ``build.HEADERS`` would let an edit to it reuse
    a stale library."""
    from repro_torch.kernels import build

    assert {p.name for p in build.CSRC.glob("*.cuh")} <= set(build.HEADERS)


# -------------------------------------------------------------------- B5
@pytest.mark.parametrize("window,softcap", DECODE_MODES)
@pytest.mark.parametrize("heads,kv_heads", LAYOUTS)
def test_decode_plain_matches_pallas_and_reference(
    jk, heads, kv_heads, window, softcap
):
    """At the first row, mid-cache and the last row."""
    _, jdec, jref = jk
    q, k, v = _qkv(heads, kv_heads, seed=heads, decode=True)
    kw = dict(window=window, softcap=softcap)
    for pos in (0, 37, 63):
        out = kernels.decode_attention(
            *_t(q, k, v), torch.tensor(pos, dtype=torch.int32), **kw
        ).numpy()
        pallas = jdec.decode_attention(
            *_j(q, k, v), jnp.int32(pos), block_k=BLOCK, interpret=True, **kw
        )
        ref = jref.decode_attention_ref(*_j(q, k, v), jnp.int32(pos), **kw)
        np.testing.assert_allclose(out, np.asarray(pallas), atol=TOL, rtol=0,
                                   err_msg=str(pos))
        np.testing.assert_allclose(out, np.asarray(ref), atol=TOL, rtol=0,
                                   err_msg=str(pos))


# ----------------------------------------------------------- KernelBranch
def test_kernel_branch_mode_switching_matches_jax(jk):
    """The kernel-level BranchChanger, gemma2-style local/global alternation
    (the JAX package's ``test_kernel_branch_mode_switching``): set_mode
    rebinds to the mode's specialisation; the branchy twin rewrites flags."""
    jops = importlib.import_module("repro.kernels.ops")
    q, k, v = _qkv(4, 4, seq=128, seed=6)
    jkb = jops.KernelBranch("t", interpret=True)
    tkb, branchy = KernelBranch("t"), KernelBranch("t", branchy=True)
    for mode in (dict(causal=True, window=64), dict(causal=True),
                 dict(causal=True, window=64), dict(causal=False, softcap=5.0)):
        jkb.set_mode(**mode)
        tkb.set_mode(**mode)
        branchy.set_mode(**mode)
        want = np.asarray(jkb(*_j(q, k, v)))
        np.testing.assert_allclose(tkb(*_t(q, k, v)).numpy(), want, atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(branchy(*_t(q, k, v)).numpy(), want,
                                   atol=TOL, rtol=0)
    assert tkb.builds == 3  # the repeated local mode was a rebind, no build
    assert branchy.builds == 0 and branchy.mode == (False, None, 5.0)


def test_branchy_kernel_branch_takes_integer_caps_only():
    kb = KernelBranch(branchy=True)
    with pytest.raises(ValueError, match="integer softcap"):
        kb.set_mode(softcap=2.5)


# ------------------------------------------------------------------ models
VARIANTS = {
    "olmo-1b": {},
    "local-global": dict(
        layer_pattern=("attn_local", "attn"), sliding_window=5,
        attn_logit_softcap=20.0, final_logit_softcap=15.0,
    ),
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    over = VARIANTS[request.param]
    cfg = dataclasses.replace(jax_config("olmo-1b").smoke(), **over)
    tcfg = dataclasses.replace(get_config("olmo-1b").smoke(), **over)
    jparams = jm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    tok = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 12)
    ).astype(np.int32)
    return cfg, tcfg, jparams, tparams, tok


@pytest.mark.parametrize("impl", models.FULL_IMPLS)
def test_forward_matches_jax(model, impl):
    cfg, tcfg, jparams, tparams, tok = model
    jl, _ = jm.forward(cfg, jparams, jnp.asarray(tok), remat=False)
    tl, aux = models.forward(tcfg, tparams, torch.from_numpy(tok), impl=impl)
    assert tl.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)


@pytest.mark.parametrize("attn_impl", models.ATTN_IMPLS)
def test_prefill_then_scalar_decode_matches_jax(model, attn_impl):
    cfg, tcfg, jparams, tparams, tok = model
    prompt, total = 8, tok.shape[1]
    jl, jcache = jm.prefill(cfg, jparams, jnp.asarray(tok[:, :prompt]))
    tl, tcache = models.prefill(tcfg, tparams, torch.from_numpy(tok[:, :prompt]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    for s, slot in enumerate(tcache):
        for name, t in slot.items():
            assert t.shape == (tcfg.num_layers // tcfg.period, 2, prompt,
                               tcfg.num_kv_heads, tcfg.head_dim)
            np.testing.assert_allclose(t.numpy(), np.asarray(jcache[s][name]),
                                       atol=CACHE_TOL, rtol=0)
    jcache = jax_pad_cache(cfg, jcache, total)
    tcache = models.pad_cache(tcfg, tcache, total)
    for pos in range(prompt, total):
        jl, jcache = jm.decode_step(cfg, jparams, jcache,
                                    jnp.asarray(tok[:, pos:pos + 1]),
                                    jnp.int32(pos))
        tl, tcache = models.decode_step(
            tcfg, tparams, tcache, torch.from_numpy(tok[:, pos:pos + 1]),
            torch.tensor(pos, dtype=torch.int32), attn_impl=attn_impl,
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0, err_msg=str(pos))
    for s, slot in enumerate(tcache):
        for name, t in slot.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jcache[s][name]),
                                       atol=CACHE_TOL, rtol=0)


def test_decode_matches_forward_last_token(model):
    """The port's twin of ``test_arch_decode_matches_forward``: prefill of
    S-1 tokens, ``pad_cache`` to S, one scalar decode step = forward's last
    position."""
    _, tcfg, _, tparams, tok = model
    t = torch.from_numpy(tok)
    s = t.shape[1]
    full, _ = models.forward(tcfg, tparams, t)
    _, cache = models.prefill(tcfg, tparams, t[:, : s - 1])
    cache = models.pad_cache(tcfg, cache, s)
    got, _ = models.decode_step(tcfg, tparams, cache, t[:, s - 1:],
                                torch.tensor(s - 1, dtype=torch.int32))
    torch.testing.assert_close(got, full[:, -1], atol=2e-4, rtol=1e-3)


def test_full_sequence_impls_agree(model):
    _, tcfg, _, tparams, tok = model
    t = torch.from_numpy(tok)
    naive, _ = models.forward(tcfg, tparams, t, impl="naive")
    for impl in ("chunked", "kernel"):
        got, _ = models.forward(tcfg, tparams, t, impl=impl)
        torch.testing.assert_close(got, naive, atol=LOGIT_TOL, rtol=0)
    with pytest.raises(ValueError, match="impl must be one of"):
        models.forward(tcfg, tparams, t, impl="flash")


@pytest.mark.parametrize("window", [None, 5])
def test_chunked_sdpa_over_several_key_blocks_matches_jax(window):
    """``chunked`` with blocks of 4 keys (the model tests' 12-token prompts
    fit one block of the default 1024): the online softmax across blocks."""
    jattn = importlib.import_module("repro.models.attention")
    from repro_torch.models import attention as tattn

    cfg = dataclasses.replace(jax_config("olmo-1b").smoke(),
                              attn_logit_softcap=20.0)
    tcfg = dataclasses.replace(get_config("olmo-1b").smoke(),
                               attn_logit_softcap=20.0)
    rng = np.random.default_rng(9)
    kh, g, dh = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    q = rng.standard_normal((2, 12, kh, g, dh)).astype(np.float32)
    k, v = (rng.standard_normal((2, 12, kh, dh)).astype(np.float32)
            for _ in range(2))
    want = jattn._sdpa_chunked(cfg, *_j(q, k, v), window=window, block=4)
    got = tattn._sdpa_chunked(tcfg, *_t(q, k, v), window=window, block=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    naive = tattn._sdpa_naive(tcfg, *_t(q, k, v), window=window)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=TOL, rtol=0)


def test_scalar_decode_writes_one_row_in_place_and_int8_raises(model):
    _, tcfg, _, tparams, _ = model
    cache = models.init_cache(tcfg, 2, 8)
    ids = [id(t) for slot in cache for t in slot.values()]
    tok = torch.zeros(2, 1, dtype=torch.int32)
    _, out = models.decode_step(tcfg, tparams, cache, tok,
                                torch.tensor(3, dtype=torch.int32))
    assert [id(t) for slot in out for t in slot.values()] == ids
    written = out[0]["k"].abs().sum(dim=(0, 1, 3, 4)) > 0  # per position
    assert written.tolist() == [False, False, False, True] + [False] * 4
    cache8 = models.init_cache(tcfg, 2, 8, "int8")
    with pytest.raises(ValueError, match="per-row pos"):
        models.decode_step(tcfg, tparams, cache8, tok,
                           torch.tensor(3, dtype=torch.int32))
