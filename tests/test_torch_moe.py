"""The mixture-of-experts path in the port against the JAX package:
granite-moe-1b-a400m.

The config equals the reference's field by field (``smoke()`` too), with its
``param_counts``. ``init_params`` draws the JAX tree's keys, shapes and
dtypes (the router float32 in a bf16 model). On granite's smoke config (4
experts, top-2, expert d_ff 32, fp32, 2 layers): ``moe_capacity``,
``_route``, ``_aux_loss`` and ``moe_apply`` under "drop", "dense" and
"gather" against ``repro.models.moe`` at S 1, 3 and 16 (within 1e-6 of the
output's scale in fp32: the same products summed in another order), a
``capacity_factor`` 0.25 variant that drops assignments, a bf16 case, and
all-equal router logits, where the chosen experts are the lowest indices as
``lax.top_k`` picks them; ``forward`` (naive, chunked, kernel) within 1e-5
of the JAX package's; streams through the paged engine (chunked prefill, and
speculation with an int8 draft), the dense continuous engine and the
per-burst engine equal to the JAX engine's under one step clock (a quarter
of the requests sampled on two of them, held token for token), and one
stream under
``moe_policy="dense"``; the same streams through graph targets whose capture
is emulated equal to the eager ones.

Under "drop" capacity follows each call's length, so a chunk or a verify
window can drop what token-by-token decode keeps: the streams are held to
the JAX engine's, never speculative to plain.

Marked ``cuda`` (skipped here): each policy on the card against the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime import serve as tserve
from repro_torch.runtime.serve import Engine, EngineConfig
from test_torch_configs import LOGIT_TOL, _near_tie, _run

ARCH = "granite-moe-1b-a400m"
TOTAL, ACTIVE = 1_334_628_352, 428_658_688
MOE_RTOL = 1e-6  # fp32: max abs error over the reference's max |y|
BF16_RTOL = 2e-2
PAGED = dict(max_len=48, max_batch=4, page_size=8, num_pages=24,
             prefill_chunk=16)
STREAMS = {
    "paged": ("paged", PAGED),
    "paged-spec-int8-draft": ("paged", dict(PAGED, prefill_chunk=8, spec_k=2,
                                            draft_layers=1,
                                            draft_kv_dtype="int8")),
    "continuous": ("continuous", dict(max_len=48, max_batch=4,
                                      prefill_chunk=16)),
    "burst": ("burst", dict(max_len=32, max_batch=8, batch_quantum=4)),
}


@pytest.fixture(scope="module")
def granite():
    """(JAX smoke config, port smoke config, JAX params, port params)."""
    jax = pytest.importorskip("jax")
    from repro import models as jm
    from repro.configs import get_config as jax_config
    from repro_torch.convert import params_from_jax

    jcfg, tcfg = jax_config(ARCH).smoke(), get_config(ARCH).smoke()
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _layer0(tparams) -> dict:
    return models.layer_params(tparams, 0, 0)["moe"]


def _jax_layer0(jparams) -> dict:
    import jax

    return jax.tree.map(lambda a: a[0], jparams["blocks"][0]["moe"])


def _x(cfg, s: int, seed: int = 0, b: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------- config
def test_config_equals_the_reference_field_by_field():
    from repro.configs import get_config as jax_config

    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.smoke()) == dataclasses.asdict(jcfg.smoke())
    assert tcfg.param_counts() == jcfg.param_counts()
    assert tcfg.param_counts()["total"] == TOTAL
    assert tcfg.param_counts()["active"] == ACTIVE
    assert (tcfg.head_dim, tcfg.dtype, tcfg.num_experts, tcfg.top_k) == (
        64, "bfloat16", 32, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_has_the_jax_trees_layout(dtype):
    """Keys, shapes and dtypes of ``init_params`` equal the JAX tree's
    through ``params_from_jax`` (the router float32 in a bf16 model), and
    the scales are ``dense_init``'s: the router 1/sqrt(D), the experts
    1/sqrt(E) (the per-layer shape's first axis)."""
    jax = pytest.importorskip("jax")
    from repro import models as jm
    from repro.configs import get_config as jax_config
    from repro_torch.convert import params_from_jax

    jcfg = dataclasses.replace(jax_config(ARCH).smoke(), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH).smoke(), dtype=dtype)
    jp = params_from_jax(jax.tree.map(
        np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0))))
    tp = models.init_params(tcfg, seed=0)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tp.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in jp.items()}
    assert tp["blocks.0.moe.router"].dtype == torch.float32
    for name, std in (("router", tcfg.d_model ** -0.5),
                      ("w_gate", tcfg.num_experts ** -0.5),
                      ("w_down", tcfg.num_experts ** -0.5)):
        got = tp[f"blocks.0.moe.{name}"].float().std().item()
        assert abs(got - std) < 0.1 * std, (name, got, std)


# ------------------------------------------------------------ the module
@pytest.mark.parametrize("s", [1, 3, 16])
def test_route_capacity_and_aux_match_jax(granite, s):
    import jax.numpy as jnp
    from repro.models import moe as jmoe

    jcfg, tcfg, jparams, tparams = granite
    x = _x(tcfg, s, seed=s)
    jg, ji, jpr = jmoe._route(jcfg, _jax_layer0(jparams), jnp.asarray(x))
    tg, ti, tpr = tmoe._route(tcfg, _layer0(tparams), torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), atol=1e-6, rtol=0)
    assert tmoe.moe_capacity(tcfg, s) == jmoe.moe_capacity(jcfg, s)
    assert tmoe.moe_capacity(get_config(ARCH), 1) == 8  # decode at full width
    assert tmoe.moe_capacity(get_config(ARCH), 64) == 20  # a chunk of 64
    np.testing.assert_allclose(
        float(tmoe._aux_loss(tcfg, ti, tpr)),
        float(jmoe._aux_loss(jcfg, ji, jpr)), atol=1e-6, rtol=0)


def _held(jy, ty, rtol: float) -> float:
    jy = np.asarray(jy, dtype=np.float32)
    err = float(np.abs(jy - ty.float().numpy()).max())
    assert err <= rtol * float(np.abs(jy).max()), (err, np.abs(jy).max())
    return err


def _apply_both(granite, x: np.ndarray, policy: str, *, cfg_change=None,
                dtype=None):
    """``moe_apply`` of both packages on layer 0 of the smoke weights (cast
    to ``dtype``), under ``cfg_change`` applied to both configs."""
    import jax.numpy as jnp
    from repro.models import moe as jmoe

    jcfg, tcfg, jparams, tparams = granite
    if cfg_change:
        jcfg = dataclasses.replace(jcfg, **cfg_change)
        tcfg = dataclasses.replace(tcfg, **cfg_change)
    jp, tp, jx, tx = _jax_layer0(jparams), _layer0(tparams), jnp.asarray(x), \
        torch.from_numpy(x)
    if dtype is not None:
        jp = {k: v if k == "router" else v.astype(jnp.bfloat16)
              for k, v in jp.items()}
        tp = {k: v if k == "router" else v.bfloat16() for k, v in tp.items()}
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    jy, ja = jmoe.moe_apply(jcfg, jp, jx, policy=policy)
    ty, ta = tmoe.moe_apply(tcfg, tp, tx, policy=policy)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6, rtol=0)
    return jy, ty, tcfg, tp, tx


@pytest.mark.parametrize("s", [1, 3, 16])
@pytest.mark.parametrize("policy", tmoe.POLICIES)
def test_moe_apply_matches_jax(granite, policy, s):
    jy, ty, *_ = _apply_both(granite, _x(granite[1], s, seed=10 + s), policy)
    _held(jy, ty, MOE_RTOL)


@pytest.mark.parametrize("policy", tmoe.POLICIES)
def test_moe_apply_matches_jax_in_bf16(granite, policy):
    """Activations and experts in bf16, the router in f32."""
    jy, ty, *_ = _apply_both(granite, _x(granite[1], 16, seed=5), policy,
                             dtype="bfloat16")
    _held(jy, ty, BF16_RTOL)


def test_drop_at_capacity_factor_quarter_drops_and_matches_jax(granite):
    """At ``capacity_factor`` 0.25 (capacity 2 for 16 tokens x top-2 over 4
    experts) "drop" drops assignments: its output moves away from
    "dense"'s on the dropped tokens and still equals the JAX package's."""
    x = _x(granite[1], 16, seed=7)
    jy, ty, tcfg, tp, tx = _apply_both(granite, x, "drop",
                                       cfg_change=dict(capacity_factor=0.25))
    _held(jy, ty, MOE_RTOL)
    assert tmoe.moe_capacity(tcfg, 16) == 2
    _, idx, _ = tmoe._route(tcfg, tp, tx)
    counts = torch.bincount(idx[0].reshape(-1), minlength=tcfg.num_experts)
    assert int((counts - 2).clamp_min(0).sum()) > 0  # assignments dropped
    dense, _ = tmoe.moe_apply(tcfg, tp, tx, policy="dense")
    assert (ty - dense).abs().max() > 1e-3


def test_equal_router_logits_pick_the_lowest_experts(granite):
    """All-equal router logits (a zero router): every token's top-k are
    experts 0..k-1 with gates 1/k, as ``lax.top_k`` orders ties; every
    policy still equals the JAX package's."""
    import jax.numpy as jnp

    jcfg, tcfg, jparams, tparams = granite
    blocks = [dict(b) for b in jparams["blocks"]]
    blocks[0]["moe"] = dict(blocks[0]["moe"], router=jnp.zeros_like(
        blocks[0]["moe"]["router"]))
    zeroed = (jcfg, tcfg, dict(jparams, blocks=blocks), dict(
        tparams, **{"blocks.0.moe.router": torch.zeros_like(
            tparams["blocks.0.moe.router"])}))
    gates, idx, _ = tmoe._route(tcfg, _layer0(zeroed[3]),
                                torch.from_numpy(_x(tcfg, 5)))
    assert (idx == torch.arange(tcfg.top_k)).all()
    assert torch.allclose(gates, torch.full_like(gates, 1 / tcfg.top_k))
    for policy in tmoe.POLICIES:
        jy, ty, *_ = _apply_both(zeroed, _x(tcfg, 5, seed=2), policy)
        _held(jy, ty, MOE_RTOL)


def test_unknown_policy_raises(granite):
    _, tcfg, _, tparams = granite
    with pytest.raises(ValueError, match="moe policy"):
        tmoe.moe_apply(tcfg, _layer0(tparams), torch.zeros(1, 1, tcfg.d_model),
                       policy="topk")
    with pytest.raises(ValueError, match="moe_policy"):
        Engine(tcfg, tparams, EngineConfig(moe_policy="topk"), device="cpu")


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
def test_forward_matches_jax(granite, impl):
    """Logits within 1e-5 of the JAX package's, and the aux term summed
    over the MoE layers."""
    import jax.numpy as jnp
    from repro import models as jm

    jcfg, tcfg, jparams, tparams = granite
    tok = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    jl, ja = jm.forward(jcfg, jparams, jnp.asarray(tok), remat=False)
    tl, ta = models.forward(tcfg, tparams, torch.from_numpy(tok), impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    assert float(ta) > 0
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-5, rtol=0)


# --------------------------------------------------------------- streams
def _reqs(sched, vocab: int, engine: str, sampled: bool) -> list:
    """Four requests with prompts of 18-24 tokens and 6-8 new tokens (the
    burst engine: eight prompt-less ones in two waves); with ``sampled``
    a quarter of them sample at temperature 1."""
    rng = np.random.default_rng(7)
    if engine == "burst":
        reqs = sched.poisson_arrivals(8, 50.0, seed=3, tokens_mean=8,
                                      tokens_max=24, sample_frac=0.0,
                                      vocab=vocab)
        for i, r in enumerate(reqs):
            r.arrival_s = 0.0 if i < 5 else 1.0
            r.greedy = not (sampled and i % 4 == 1)
        return reqs
    return [
        sched.Request(rid=i, new_tokens=6 + i % 3,
                      greedy=not (sampled and i % 4 == 1),
                      arrival_s=0.002 * i, prompt=tuple(
                          int(x) for x in rng.integers(0, vocab, 18 + 2 * i)))
        for i in range(4)
    ]


def _match_jax(granite, engine: str, ecfg: dict, sampled: bool) -> dict:
    """The same requests through the JAX engine and the port's (CPU) under
    one step clock: greedy tokens equal (a first divergence only at a
    near-tie of the JAX logits), sampled tokens equal, every request
    finished, no build after warmup on the continuous engines, the burst
    engine's builds equal."""
    from repro.core import reset_entry_points
    from repro.runtime import scheduler as jsched
    from repro.runtime import serve as jserve

    jcfg, tcfg, jparams, tparams = granite
    reset_entry_points()
    jreqs = _reqs(jsched, tcfg.vocab_size, engine, sampled)
    treqs = _reqs(tsched, tcfg.vocab_size, engine, sampled)
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
        if not r.greedy:
            assert r.tokens == j.tokens, r.rid
        elif r.tokens != j.tokens:
            i = next(i for i, (a, b) in enumerate(zip(r.tokens, j.tokens))
                     if a != b)
            assert _near_tie(jcfg, jparams, j.effective_prompt, j.tokens, i), (
                r.rid, i)
    return trep


@pytest.mark.parametrize("stream", list(STREAMS))
def test_streams_match_jax(granite, stream):
    """Streams through each engine (``moe_policy`` "drop"), equal to the
    JAX engine's; on the paged and continuous chunked streams a quarter of
    the requests sample, their tokens held token for token (threefry keys
    in the step); the speculative and chunk lanes ran."""
    engine, ecfg = STREAMS[stream]
    trep = _match_jax(granite, engine, ecfg,
                      sampled=stream in ("paged", "continuous"))
    if engine != "burst":
        assert trep["prefill_chunks"] > 0
    if "spec_k" in ecfg:
        assert trep["lane_steps"]["draft"] > 0
        assert trep["lane_steps"]["verify"] > 0


def test_dense_policy_stream_matches_jax(granite):
    """The paged chunked stream under ``moe_policy="dense"`` against the
    JAX engine under "dense"."""
    _match_jax(granite, "paged", dict(PAGED, moe_policy="dense"),
               sampled=False)


@pytest.mark.parametrize("stream", ["paged-spec-int8-draft", "continuous",
                                    "burst"])
def test_streams_through_emulated_graphs_equal_eager(granite, monkeypatch,
                                                     stream):
    """Graph targets whose capture is emulated on the CPU (a replay reruns
    the step and clobbers every other target's static outputs) give the
    eager targets' tokens, a quarter of the requests sampled."""
    import repro_torch.core as tcore
    from test_torch_graphs import _emulated

    _, tcfg, _, tparams = granite
    engine, ecfg = STREAMS[stream]
    out = {}
    for graphs in (True, False):
        tcore.reset_entry_points()
        reqs = _reqs(tsched, tcfg.vocab_size, engine, sampled=True)
        with Engine(tcfg, tparams, EngineConfig(**ecfg), device="cpu") as eng:
            if graphs:
                _emulated(monkeypatch, eng)
            rep = _run(engine, tserve, eng, reqs)
            kinds = {type(t).__name__
                     for t in eng._decode.cache._table.values()}
        monkeypatch.undo()
        assert kinds == ({"_GraphStep"} if graphs else {"function"})
        out[graphs] = ({r.rid: r.tokens for r in reqs},
                       rep["compiles_after_warmup"])
    assert out[True] == out[False]


# ---------------------------------------------------------------- the card
@pytest.mark.cuda
@pytest.mark.parametrize("policy", tmoe.POLICIES)
def test_cuda_moe_apply_equals_the_cpu(policy):
    """Each policy on the card (bf16 experts, f32 router) against the same
    call on the CPU in f32 from the same bf16 values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config(ARCH)
    p = {k[len("blocks.0.moe."):]: v[0] for k, v in models.init_params(
        dataclasses.replace(cfg, num_layers=1), seed=0,
        device="cuda").items() if ".moe." in k}
    x = torch.randn(4, 3, cfg.d_model, generator=torch.Generator().manual_seed(0)
                    ).bfloat16()
    y, _ = tmoe.moe_apply(cfg, p, x.cuda(), policy=policy)
    ref, _ = tmoe.moe_apply(cfg, {k: v.float().cpu() for k, v in p.items()},
                            x.float(), policy=policy)
    err = (y.float().cpu() - ref).abs().max().item()
    assert err <= BF16_RTOL * ref.abs().max().item()
