"""The port's paged model path against ``repro.models`` on identical weights.

``params_from_jax`` carries the JAX package's ``init_params`` tree over
(leaves converted to numpy here, in the test); then one chunked prefill step
and one decode step run through both packages at ``olmo-1b``'s smoke config
(fp32). Tolerances: logits atol 1e-4 (fp32 through two layers, products
summed in another order); cache pages atol 1e-5 after the writes. Page 0 is
never compared: every padded column and inactive row writes there, in no
defined order.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_config as jax_config
from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax

LOGIT_TOL = 1e-4
PAGE_TOL = 1e-5


# The olmo-1b smoke config, and a variant that turns on every other branch
# of the paged path (rmsnorm, qk_norm, GeGLU, an untied head, embedding
# scale, local/global layers with a sliding window, both softcaps).
VARIANTS = {
    "olmo-1b": {},
    "all-branches": dict(
        norm="rmsnorm", qk_norm=True, act="gelu", tie_embeddings=False,
        embed_scale=True, layer_pattern=("attn_local", "attn"),
        sliding_window=6, attn_logit_softcap=20.0, final_logit_softcap=15.0,
    ),
}


def _setup(variant: str):
    cfg = dataclasses.replace(jax_config("olmo-1b").smoke(), **VARIANTS[variant])
    tcfg = dataclasses.replace(get_config("olmo-1b").smoke(), **VARIANTS[variant])
    jparams = jm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return cfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def smoke():
    return _setup("olmo-1b")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (str(i),))
    else:
        yield ".".join(prefix), np.asarray(tree)


def test_params_from_jax_round_trip(smoke):
    _, _, jparams, tparams = smoke
    leaves = dict(_flat(jparams))
    assert set(leaves) == set(tparams)
    for name, a in leaves.items():
        np.testing.assert_array_equal(tparams[name].numpy(), a, err_msg=name)


def test_params_from_jax_keeps_bf16_bits():
    a = (np.arange(12, dtype=np.float32) / 7).astype(ml_dtypes.bfloat16)
    t = params_from_jax({"w": a.reshape(3, 4)})["w"]
    assert t.dtype == torch.bfloat16 and t.shape == (3, 4)
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy(), a.view(np.int16).reshape(3, 4)
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_jax_layout(dtype):
    jcfg = dataclasses.replace(jax_config("olmo-1b").smoke(), dtype=dtype)
    tcfg = dataclasses.replace(get_config("olmo-1b").smoke(), dtype=dtype)
    jshapes = {
        k: (tuple(v.shape), str(v.dtype))
        for k, v in _flat(jm.init_params(jcfg, jax.random.PRNGKey(0)))
    }
    tshapes = {
        k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
        for k, v in tm.init_params(tcfg, seed=0).items()
    }
    assert tshapes == jshapes


def _step_inputs(cfg):
    rng = np.random.default_rng(3)
    b, c = 3, 8
    return dict(
        tok=rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32),
        start=np.array([0, 8, 3], np.int32),
        length=np.array([8, 5, 0], np.int32),  # row 2 idle, row 1 padded
        # rows 0 and 1 share page 1; row 2 is all null
        bt=np.array([[1, 2, 0, 0], [1, 4, 5, 0], [0, 0, 0, 0]], np.int32),
        dtok=rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32),
        pos=np.array([8, 13, 0], np.int32),
    )


def _assert_pages_close(jcache, tcache):
    assert len(tcache) == len(jcache)
    for s, slot in enumerate(tcache):
        for leaf, t in slot.items():
            np.testing.assert_allclose(
                t[:, 1:].numpy(), np.asarray(jcache[s][leaf])[:, 1:],
                atol=PAGE_TOL, rtol=PAGE_TOL, err_msg=f"slot {s} {leaf}",
            )


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
def test_paged_prefill_then_decode_match_jax(variant, attn_impl):
    cfg, tcfg, jparams, tparams = _setup(variant)
    x = _step_inputs(cfg)
    n_pages, ps = 12, 8
    jcache = jm.init_paged_cache(cfg, n_pages, ps)
    tcache = tm.init_paged_cache(tcfg, n_pages, ps)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: torch.from_numpy(v) for k, v in x.items()}

    jl, jcache = jm.paged_prefill_step(
        cfg, jparams, jcache, j["tok"], j["start"], j["bt"], j["length"]
    )
    tl, tcache = tm.paged_prefill_step(
        tcfg, tparams, tcache, t["tok"], t["start"], t["bt"], t["length"],
        attn_impl=attn_impl,
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    _assert_pages_close(jcache, tcache)

    jl, jcache = jm.paged_decode_step(
        cfg, jparams, jcache, j["dtok"], j["pos"], j["bt"]
    )
    tl, tcache = tm.paged_decode_step(
        tcfg, tparams, tcache, t["dtok"], t["pos"], t["bt"],
        attn_impl=attn_impl,
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    _assert_pages_close(jcache, tcache)


def test_padded_columns_and_idle_rows_write_only_the_null_page(smoke):
    _, tcfg, _, tparams = smoke
    x = _step_inputs(tcfg)
    tcache = tm.init_paged_cache(tcfg, 12, 8)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    tm.paged_prefill_step(
        tcfg, tparams, tcache, t["tok"], t["start"], t["bt"], t["length"]
    )
    k = tcache[0]["k"]  # [m, P, ps, KH, dh]
    written = k.abs().sum(dim=(0, 3, 4)) > 0  # [P, ps]
    # row 0: positions 0..7 on page 1; row 1: positions 8..12 on page 4
    # (its 3 padded columns go to page 0); row 2 idle
    expect = torch.zeros_like(written)
    expect[1, :] = True
    expect[4, :5] = True
    assert torch.equal(written[1:], expect[1:])


def test_copy_cache_pages_copies_every_layer_in_place(smoke):
    _, tcfg, _, _ = smoke
    cache = tm.init_paged_cache(tcfg, 6, 8)
    for slot in cache:
        for t in slot.values():
            t.normal_()
    before = [{k: t.clone() for k, t in s.items()} for s in cache]
    ids = [id(t) for s in cache for t in s.values()]
    out = tm.copy_cache_pages(cache, 2, 5)
    assert [id(t) for s in out for t in s.values()] == ids
    for s, slot in enumerate(out):
        for k, t in slot.items():
            torch.testing.assert_close(t[:, 5], before[s][k][:, 2])
            torch.testing.assert_close(t[:, 3], before[s][k][:, 3])
