"""The last five architectures in the port against the JAX package:
deepseek-67b (dense, GQA 64 over 8), grok-1-314b (8 experts top-2, softcaps
30/30), jamba-1.5-large-398b (the hybrid stack: mamba and attention layers,
MoE on every other layer) and the embeddings-input archs internvl2-1b and
musicgen-medium (a stub frontend feeds ``[B,S,D]`` embeddings; no token
embedding table).

Each config equals the reference's field by field (``smoke()`` too), with
its ``param_counts``; ``init_params`` draws the JAX tree's keys, shapes and
dtypes (no ``embed.embedding`` and an untied head for the embeddings
archs). On the smoke configs: ``forward`` (naive, chunked, kernel) within
1e-5 of the JAX package's; streams equal to the JAX engine's under one step
clock — jamba through the dense continuous engine (prompts token by token,
as for any SSM slot) and the per-burst engine, deepseek through the paged
engine with chunked prefill, grok through the paged engine with
speculation and an int8 draft and through the per-burst engine, a quarter
of the requests sampled where the stream has no draft; for the embeddings
archs ``prefill`` + ``pad_cache`` + a one-step ``decode_loop`` (greedy and
sampled, eager and through emulated graph targets) equal to the JAX
engine's, and the refusals the JAX package makes: ``num_tokens > 1``, the
continuous engines and the launcher; jamba's paged refusal.

Weights are the JAX package's ``init_params`` through ``params_from_jax``;
inputs come from a numpy seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.runtime.serve import GREEDY, SAMPLE, Engine, EngineConfig
from test_torch_configs import LOGIT_TOL
from test_torch_moe import STREAMS, _match_jax

PARAM_COUNTS = {
    "deepseek-67b": (67_425_001_472, 67_425_001_472),
    "grok-1-314b": (316_489_340_928, 84_561_106_944),
    "jamba-1.5-large-398b": (397_710_875_136, 93_305_068_032),
    "internvl2-1b": (493_753_344, 493_753_344),
    "musicgen-medium": (1_815_234_048, 1_815_234_048),
}
EMBEDS = ("internvl2-1b", "musicgen-medium")
BURST = dict(max_len=32, max_batch=4, batch_quantum=4)
PROMPT = 12  # embeddings prompt length of the one-step decode


@pytest.fixture(scope="module")
def fam():
    """arch -> (JAX smoke config, port smoke config, JAX params, port
    params), made on first use."""
    jax = pytest.importorskip("jax")
    from repro import models as jm
    from repro.configs import get_config as jax_config
    from repro_torch.convert import params_from_jax

    made: dict = {}

    def get(arch: str):
        if arch not in made:
            jcfg, tcfg = jax_config(arch).smoke(), get_config(arch).smoke()
            jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
            tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
            made[arch] = (jcfg, tcfg, jparams, tparams)
        return made[arch]

    return get


def _inputs(cfg, batch: int, seq: int, seed: int = 0) -> np.ndarray:
    """Token ids, or stub-frontend embeddings for an embeddings arch."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "tokens":
        return rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", list(PARAM_COUNTS))
def test_config_equals_the_reference_field_by_field(arch):
    from repro.configs import get_config as jax_config

    jcfg, tcfg = jax_config(arch), get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.smoke()) == dataclasses.asdict(jcfg.smoke())
    assert tcfg.param_counts() == jcfg.param_counts()
    got = tcfg.param_counts()
    assert (got["total"], got["active"]) == PARAM_COUNTS[arch]


@pytest.mark.parametrize("arch", list(PARAM_COUNTS))
def test_init_params_has_the_jax_trees_layout(fam, arch):
    """Keys, shapes and dtypes of ``init_params`` equal the JAX tree's
    through ``params_from_jax``; an embeddings arch has no embedding table
    and an untied head."""
    _, tcfg, _, jp = fam(arch)
    tp = models.init_params(tcfg, seed=0)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tp.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in jp.items()}
    assert ("embed.embedding" in tp) == (arch not in EMBEDS)
    assert tp["head.lm_head"].shape == (tcfg.d_model, tcfg.vocab_size)


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
@pytest.mark.parametrize("arch", list(PARAM_COUNTS))
def test_forward_matches_jax(fam, arch, impl):
    """Logits within 1e-5 of the JAX package's (naive attention, the SSD
    scan), and the MoE aux terms equal."""
    import jax.numpy as jnp
    from repro import models as jm

    jcfg, tcfg, jparams, tparams = fam(arch)
    x = _inputs(tcfg, 2, 24)
    jl, ja = jm.forward(jcfg, jparams, jnp.asarray(x), remat=False)
    tl, ta = models.forward(tcfg, tparams, torch.from_numpy(x), impl=impl)
    assert tl.shape == jl.shape == (2, 24, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-5, rtol=0)


# ---------------------------------------------------------------- streams
FAMILY_STREAMS = {
    "jamba-continuous": ("jamba-1.5-large-398b", "continuous", True),
    "jamba-burst": ("jamba-1.5-large-398b", "burst", True),
    "deepseek-paged": ("deepseek-67b", "paged", True),
    "grok-paged-spec-int8-draft": ("grok-1-314b", "paged-spec-int8-draft",
                                   False),
    "grok-burst": ("grok-1-314b", "burst", False),
}


@pytest.mark.parametrize("name", list(FAMILY_STREAMS))
def test_streams_match_jax(fam, name):
    """Streams equal to the JAX engine's under one step clock (greedy
    tokens, a first divergence only at a near-tie; sampled tokens equal),
    every request finished, 0 builds after warmup on the continuous
    engines, the burst engine's builds equal; jamba's prompts go through
    ``cb`` token by token (no chunk lane for an SSM slot)."""
    arch, stream, sampled = FAMILY_STREAMS[name]
    engine, ecfg = STREAMS[stream]
    trep = _match_jax(fam(arch), engine, ecfg, sampled)
    if arch == "jamba-1.5-large-398b" and engine == "continuous":
        assert trep["prefill_chunks"] == 0
        assert trep["prompt_tokens"] > 0
    elif engine == "paged":
        assert trep["prefill_chunks"] > 0
    if "spec_k" in ecfg:
        assert trep["lane_steps"]["draft"] > 0
        assert trep["lane_steps"]["verify"] > 0


def test_jamba_paged_path_is_refused_as_in_jax(fam):
    """The paged path is attention-only in both packages: the same
    message from ``init_paged_cache``, and the engine and the launcher
    refuse jamba."""
    from repro import models as jm
    from repro_torch.launch import serve as launch

    jcfg, tcfg, jparams, tparams = fam("jamba-1.5-large-398b")
    with pytest.raises(ValueError) as je:
        jm.init_paged_cache(jcfg, 8, 8)
    with pytest.raises(ValueError) as te:
        models.init_paged_cache(tcfg, 8, 8)
    assert str(te.value) == str(je.value)
    with Engine(tcfg, tparams, EngineConfig(**BURST), device="cpu") as eng:
        with pytest.raises(ValueError, match="attention-only"):
            eng.paged_continuous()
    with pytest.raises(SystemExit):
        launch.parse_args(["--engine", "paged", "--arch",
                           "jamba-1.5-large-398b", "--smoke"])


# ------------------------------------------------------ embeddings archs
def _one_step(eng, cfg, params, emb: np.ndarray, nxt: np.ndarray,
              mode: int, key, graphs: bool) -> np.ndarray:
    """``prefill`` + ``pad_cache`` + ``set_mode`` + a one-step
    ``decode_loop`` on the port; with ``graphs`` the cache goes into the
    bucket's burst cache, the one its target was captured over."""
    _, cache = models.prefill(cfg, params, torch.from_numpy(emb))
    cache = models.pad_cache(cfg, cache, BURST["max_len"])
    b = emb.shape[0]
    eng.set_mode(batch=b, sampling=mode)
    if graphs:
        dst = eng.burst_cache(b)
        for d, c in zip(dst, cache, strict=True):
            for k, t in c.items():
                d[k][:, :, :t.shape[2]].copy_(t)
        cache = dst
    toks, _ = eng.decode_loop(cache, torch.from_numpy(nxt), PROMPT, 1,
                              rng=key)
    return toks


@pytest.mark.parametrize("mode", [GREEDY, SAMPLE], ids=["greedy", "sampled"])
@pytest.mark.parametrize("arch", EMBEDS)
def test_embeddings_one_step_decode_matches_jax(fam, monkeypatch, arch,
                                                mode):
    """Seeded ``[4, 12, D]`` embeddings through ``prefill``, ``pad_cache``
    and a one-step ``decode_loop`` fed ``[4, D]`` embeddings (``[4, 1, D]``
    too): the tokens equal the JAX engine's, eager and through emulated
    graph targets (the target's static input ``[B,1,D]`` in the model
    dtype); ``prefill``'s last logits within 1e-5 of the JAX package's."""
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro.core import reset_entry_points
    from repro.models import model as jmodel
    from repro.runtime import serve as jserve
    from test_torch_graphs import _emulated

    jcfg, tcfg, jparams, tparams = fam(arch)
    emb = _inputs(tcfg, 4, PROMPT, seed=1)
    nxt = _inputs(tcfg, 4, 1, seed=2)[:, 0]
    jkey = jax.random.PRNGKey(5)
    tkey = torch.from_numpy(np.asarray(jkey).view(np.int32).copy())
    reset_entry_points()
    jlast, jcache = jm.prefill(jcfg, jparams, jnp.asarray(emb))
    jcache = jmodel.pad_cache(jcfg, jcache, BURST["max_len"])
    with jserve.Engine(jcfg, jparams, jserve.EngineConfig(**BURST)) as jeng:
        jeng.set_mode(batch=4, sampling=mode)
        want, _ = jeng.decode_loop(jcache, jnp.asarray(nxt), PROMPT, 1,
                                   rng=jkey)
    tlast, _ = models.prefill(tcfg, tparams, torch.from_numpy(emb))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                               atol=LOGIT_TOL, rtol=0)
    for graphs, feed in ((False, nxt), (False, nxt[:, None]), (True, nxt)):
        with Engine(tcfg, tparams, EngineConfig(**BURST), device="cpu") as eng:
            if graphs:
                _emulated(monkeypatch, eng)
            got = _one_step(eng, tcfg, tparams, emb, feed, mode, tkey, graphs)
            kinds = {type(t).__name__
                     for t in eng._decode.cache._table.values()}
        monkeypatch.undo()
        assert kinds == ({"_GraphStep"} if graphs else {"function"})
        assert got.shape == (4, 1)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", EMBEDS)
def test_embeddings_archs_refuse_what_jax_refuses(fam, arch):
    """``decode_loop`` past one token, the continuous engines and the
    launcher refuse an embeddings arch with the JAX package's messages."""
    import jax.numpy as jnp
    from repro.core import reset_entry_points
    from repro.launch import serve as jlaunch
    from repro.runtime import serve as jserve
    from repro_torch.launch import serve as launch

    jcfg, tcfg, jparams, tparams = fam(arch)
    nxt = _inputs(tcfg, 4, 1)[:, 0]
    reset_entry_points()
    with jserve.Engine(jcfg, jparams, jserve.EngineConfig(**BURST)) as jeng:
        jeng.set_mode(batch=4, sampling=GREEDY)
        with pytest.raises(ValueError) as je:
            jeng.decode_loop(None, jnp.asarray(nxt), 0, 2)
        jerrs = []
        for name in ("continuous", "paged_continuous"):
            with pytest.raises(ValueError) as e:
                getattr(jeng, name)()
            jerrs.append(str(e.value))
    with Engine(tcfg, tparams, EngineConfig(**BURST), device="cpu") as eng:
        eng.set_mode(batch=4, sampling=GREEDY)
        with pytest.raises(ValueError) as te:
            eng.decode_loop(eng.burst_cache(4), torch.from_numpy(nxt), 0, 2)
        assert str(te.value) == str(je.value)
        for name, want in zip(("continuous", "paged_continuous"), jerrs):
            with pytest.raises(ValueError) as e:
                getattr(eng, name)()
            assert str(e.value) == want
    argv = ["--arch", arch, "--smoke", "--engine", "burst"]
    with pytest.raises(SystemExit) as je:
        jlaunch.main(argv)
    with pytest.raises(SystemExit) as te:
        launch.main(argv + ["--device", "cpu"])
    assert str(te.value) == str(je.value)
    assert "stub modality frontend" in str(te.value)
