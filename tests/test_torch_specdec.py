"""Speculative decoding on the port's paged engine against the JAX package
(DESIGN.md §11).

The truncated-layer draft view; verify-lane rows against sequential decode;
the draft's per-row dense decode and chunked ingestion against the JAX
package (model-dtype and int8 caches); greedy spec streams equal to the
port's plain greedy stream and to the JAX package's spec stream; committed
cache bits after rollback; k-bucket crossings and warmup completeness
without builds; an int8 draft beside a model-dtype verify pool.

Weights are the JAX package's ``init_params`` at olmo-1b's smoke config
(fp32) through ``params_from_jax``. Tolerances: logits 1e-5 (fp32, products
summed in another order); verify rows against sequential decode 1e-5, not
bitwise (the chunk path sums in another order than the one-token path;
ROADMAP queue C item 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch
from repro_torch.runtime.scheduler import LanePolicy, Request
from repro_torch.runtime.serve import Engine, EngineConfig, run_paged_stream

LOGIT_TOL = 1e-5
ENGINE = dict(max_len=64, max_batch=4, page_size=8, num_pages=40,
              prefill_chunk=16, draft_layers=1)


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


def _prompt_reqs(vocab, n=3, prompt_len=20, new_tokens=8, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [
        cls(rid=i, new_tokens=new_tokens, greedy=True, arrival_s=0.0,
            prompt=tuple(int(x) for x in rng.integers(0, vocab, prompt_len)))
        for i in range(n)
    ]


def _engine(tcfg, tparams, **kw):
    return Engine(tcfg, tparams, EngineConfig(**{**ENGINE, **kw}), device="cpu")


# ------------------------------------------------------------- draft view
def test_draft_view_truncates_layers_and_shares_embed(smoke):
    _, tcfg, _, tparams = smoke
    cfg = dataclasses.replace(tcfg, num_layers=4).validate()
    params = models.init_params(cfg, seed=1)
    dcfg, dparams = models.draft_view(cfg, params, 1)
    assert dcfg.num_layers == cfg.period and dcfg.name.endswith("-draft1")
    assert set(dparams) == set(params)
    for name, t in params.items():
        if name.startswith("blocks."):
            assert dparams[name].shape[0] == 1
            assert dparams[name].data_ptr() == t.data_ptr()  # a view
            torch.testing.assert_close(dparams[name], t[:1], atol=0, rtol=0)
        else:
            assert dparams[name] is t  # shared, not copied
    fcfg, _ = models.draft_view(cfg, params, 99)  # full depth is the target
    assert fcfg.num_layers == cfg.num_layers


# ------------------------------------------------ verify rows vs decode
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
def test_verify_rows_match_sequential_decode(smoke, kv_dtype, attn_impl):
    """Every verify-window row's logits are the logits sequential decode
    gives after feeding the earlier rows (within 1e-5, not bitwise)."""
    _, tcfg, _, tparams = smoke
    ps, pb = 4, 8
    bt = torch.arange(1, pb + 1, dtype=torch.int32)[None]
    window = np.random.default_rng(1).integers(0, tcfg.vocab_size, 5)
    seq_cache = models.init_paged_cache(tcfg, 1 + pb, ps, kv_dtype)
    seq = []
    for i, t in enumerate(window):
        ld, _ = models.paged_decode_step(
            tcfg, tparams, seq_cache, torch.tensor([[t]], dtype=torch.int32),
            torch.tensor([i], dtype=torch.int32), bt, attn_impl=attn_impl,
        )
        seq.append(ld[0])
    vf_cache = models.init_paged_cache(tcfg, 1 + pb, ps, kv_dtype)
    lv, _ = models.paged_verify_step(
        tcfg, tparams, vf_cache,
        torch.tensor(window[None], dtype=torch.int32),
        torch.tensor([0], dtype=torch.int32), bt,
        torch.tensor([5], dtype=torch.int32), attn_impl=attn_impl,
    )
    assert lv.shape == (1, 5, tcfg.vocab_size)
    torch.testing.assert_close(lv[0], torch.stack(seq), atol=LOGIT_TOL, rtol=0)


# ------------------------------------------ the draft's dense cache vs JAX
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_dense_decode_and_chunk_steps_match_jax(smoke, kv_dtype):
    """Per-row ``decode_step`` and ``chunked_decode_step`` over the dense
    per-slot cache, on the same inputs as the JAX package: logits within
    1e-5, written rows within 1e-5 (int8: values within a rounding tie,
    scales to 1e-6)."""
    import jax.numpy as jnp
    from repro import models as jm

    cfg, tcfg, jparams, tparams = smoke
    rng = np.random.default_rng(5)
    b, smax, c = 3, 24, 8
    tok = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
    start = np.array([0, 5, 16], np.int32)
    length = np.array([8, 3, 0], np.int32)  # row 2 idle
    dtok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    pos = np.array([8, 8, 23], np.int32)  # row 2 at the last row
    jcache = jm.init_cache(cfg, b, smax, kv_dtype)
    tcache = models.init_cache(tcfg, b, smax, kv_dtype)

    jl, jcache = jm.chunked_decode_step(
        cfg, jparams, jcache, jnp.asarray(tok), jnp.asarray(start),
        jnp.asarray(length),
    )
    tl, _ = models.chunked_decode_step(
        tcfg, tparams, tcache, torch.from_numpy(tok), torch.from_numpy(start),
        torch.from_numpy(length),
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    jl, jcache = jm.decode_step(
        cfg, jparams, jcache, jnp.asarray(dtok), jnp.asarray(pos)
    )
    tl, _ = models.decode_step(
        tcfg, tparams, tcache, torch.from_numpy(dtok), torch.from_numpy(pos)
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    for s, slot in enumerate(tcache):
        for name, t in slot.items():
            j = np.asarray(jcache[s][name])
            if t.dtype == torch.int8:
                diff = np.abs(t.numpy().astype(np.int32) - j.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name
            elif name in ("ks", "vs"):
                np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, err_msg=name)
            else:
                np.testing.assert_allclose(t.numpy(), j, atol=1e-5, rtol=1e-5,
                                           err_msg=name)


def test_dense_decode_takes_per_row_positions_only(smoke):
    """On the draft's int8 dense cache: the scalar-position form (the burst
    engine's) takes model-dtype caches only, as in the JAX package."""
    _, tcfg, _, tparams = smoke
    cache = models.init_cache(tcfg, 2, 8, "int8")
    with pytest.raises(ValueError, match="per-row pos"):
        models.decode_step(tcfg, tparams, cache,
                           torch.zeros(2, 1, dtype=torch.int32),
                           torch.tensor(3, dtype=torch.int32))


# ---------------------------------------------------------- lane policy
def test_lane_policy_budget_split_and_k_buckets():
    pol = LanePolicy(token_budget=12, spec_k=4)
    plan = pol.plan(n_decode=2, max_remaining=0)  # nothing draft-eligible
    assert plan.k == 0 and plan.chunk_budget == 10
    plan = pol.plan(n_decode=2, max_remaining=10)  # each slot budgets 1 + k
    assert plan.k == 4 and plan.chunk_budget == 12 - 2 * 5
    assert pol.plan(n_decode=1, max_remaining=3).k == 2
    assert pol.plan(n_decode=1, max_remaining=2).k == 1
    assert pol.plan(n_decode=1, max_remaining=1).k == 0
    assert LanePolicy(token_budget=12).plan(n_decode=2, max_remaining=99).k == 0


# --------------------------------------------------------------- streams
def test_spec_stream_matches_plain_greedy_and_jax_spec_stream(smoke):
    """Greedy speculative streams emit what plain greedy decode emits, and
    what the JAX package's spec stream emits, with zero builds after warmup
    and the draft, verify and draft-prompt lanes all exercised."""
    from repro.core import reset_entry_points
    from repro.runtime import scheduler as jsched
    from repro.runtime import serve as jserve

    cfg, tcfg, jparams, tparams = smoke
    spec, plain = (_prompt_reqs(cfg.vocab_size) for _ in range(2))
    with _engine(tcfg, tparams, spec_k=2) as eng:
        rep = run_paged_stream(eng, spec, slots=4)
    with _engine(tcfg, tparams, spec_k=0) as eng:
        run_paged_stream(eng, plain, slots=4)
    jreqs = _prompt_reqs(cfg.vocab_size, cls=jsched.Request)
    reset_entry_points()
    jeng = jserve.Engine(cfg, jparams, jserve.EngineConfig(
        batch_quantum=2, spec_k=2, **{k: v for k, v in ENGINE.items()}))
    try:
        jrep = jserve.run_paged_stream(jeng, jreqs, slots=4)
    finally:
        jeng.close()

    assert rep["finished"] == jrep["finished"] == 3
    assert rep["compiles_after_warmup"] == 0
    assert rep["lane_steps"]["draft"] > 0 and rep["lane_steps"]["verify"] > 0
    assert rep["lane_calls"]["drp"] > 0
    assert rep["k_bucket_crossings"] >= 1
    st = rep["spec"]
    assert 0 <= st["accepted_tokens"] <= st["drafted_tokens"] > 0
    assert [r.tokens for r in spec] == [r.tokens for r in plain]
    assert [r.tokens for r in spec] == [r.tokens for r in jreqs]
    assert rep["lane_steps"] == jrep["lane_steps"]
    assert st["drafted_tokens"] == jrep["spec"]["drafted_tokens"]
    assert st["accepted_tokens"] == jrep["spec"]["accepted_tokens"]


def test_spec_cache_bits_equal_after_rollback(smoke):
    """Mid-stream, each request's committed logical KV (gathered through
    its block table) is bitwise what a plain run wrote at the same emitted
    count: rejected draft KV was overwritten or lies past the frontier."""
    _, tcfg, _, tparams = smoke

    def gathered(cb, upto):
        table = cb._tables[0]
        out = []
        for slot in cb._cache:
            for t in slot.values():
                pages = t[:, table.pages]  # [m, P_req, ps, ...]
                out.append(pages.reshape(t.shape[0], -1, *t.shape[3:])[:, :upto])
        return out

    def run(spec_k, emitted=None):
        eng = _engine(tcfg, tparams, spec_k=spec_k, max_batch=2)
        cb = eng.paged_continuous(slots=2)
        req = _prompt_reqs(tcfg.vocab_size, n=1, prompt_len=12, new_tokens=12)[0]
        cb.admit([req], now=0.0)
        while cb.has_work and (emitted is None or len(req.tokens) < emitted):
            cb.step()
        eng.close()
        return cb, req

    cb_s, req_s = run(2, emitted=6)  # mid-stream: rollbacks happened
    e = len(req_s.tokens)
    assert 0 < e < 12 and cb_s.stats.drafted_tokens > cb_s.stats.accepted_tokens
    cb_p, req_p = run(0, emitted=e)
    assert req_p.tokens[:e] == req_s.tokens[:e]
    upto = 12 - 1 + e  # prompt-1 + emitted positions written
    for a, b in zip(gathered(cb_s, upto), gathered(cb_p, upto)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_k_crossing_rebinds_without_building(smoke):
    """Draining requests shrink the useful window, the lane policy drops k,
    and the crossing re-dispatches warmed targets: rebinds, no builds."""
    _, tcfg, _, tparams = smoke
    reqs = _prompt_reqs(tcfg.vocab_size, n=2, prompt_len=12, new_tokens=10)
    with _engine(tcfg, tparams, spec_k=4, max_batch=2) as eng:
        rep = run_paged_stream(eng, reqs, slots=2)
    assert rep["k_bucket_crossings"] >= 2  # 4 -> 2 -> 1 as the tail drains
    assert rep["compiles_after_warmup"] == 0 and rep["rebinds"] > 0


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_warmup_covers_every_enabled_lane_key(smoke, kv_dtype):
    """Every decode capacity bucket, chunk bucket, k bucket and draft
    prompt bucket exists after warmup: dispatching any of them builds
    nothing."""
    _, tcfg, _, tparams = smoke
    s = 4
    with _engine(tcfg, tparams, spec_k=4, kv_dtype=kv_dtype,
                 draft_kv_dtypes=("int8",)) as eng:
        cb = eng.paged_continuous(slots=s)
        built = eng._decode.stats.misses
        keys = (
            [("cbp", s, pb, kv_dtype) for pb in eng._pages_buckets()]
            + [("pf", s, c, kv_dtype) for c in eng._chunk_buckets()]
            + [("vf", s, k, kv_dtype) for k in eng._k_buckets()]
            + [("dr", s, k, d) for k in eng._k_buckets() for d in ("fp32", "int8")]
            + [("drp", s, c, d) for c in eng._chunk_buckets()
               for d in ("fp32", "int8")]
        )
        assert eng._k_buckets() == [1, 2, 4]
        for key in keys:
            assert key in eng._decode, key
            eng._decode.dispatch(key)
        for k in eng._k_buckets():
            cb._draft_dispatch(k)
            cb._verify_dispatch(k)
        for c in eng._chunk_buckets():
            cb._draft_prefill_dispatch(c)
        assert eng._decode.stats.misses == built
        assert len(eng._decode) == len(keys)


def test_spec_decode_false_leaves_the_spec_lanes_cold(smoke):
    """``paged_continuous(spec_decode=False)`` on a spec engine serves
    without speculation and warms none of its lanes."""
    _, tcfg, _, tparams = smoke
    with _engine(tcfg, tparams, spec_k=2) as eng:
        cb = eng.paged_continuous(slots=4, spec_decode=False)
        assert cb.spec_k == 0 and cb._draft_cache is None
        for key in (("vf", 4, 1, "fp32"), ("dr", 4, 1, "fp32"),
                    ("drp", 4, 8, "fp32")):
            assert key not in eng._decode
        assert ("cbp", 4, 1, "fp32") in eng._decode


def test_int8_draft_pairs_with_model_dtype_verify_stream(smoke):
    """An int8 draft cache under a model-dtype verify pool emits the same
    greedy stream as a model-dtype draft — the verify lane owns correctness
    — and proposes the same candidates on this workload."""
    _, tcfg, _, tparams = smoke
    streams, spec = {}, {}
    for ddt in ("fp32", "int8"):
        reqs = _prompt_reqs(tcfg.vocab_size, prompt_len=12, new_tokens=6)
        with _engine(tcfg, tparams, spec_k=2, draft_kv_dtype=ddt) as eng:
            rep = run_paged_stream(eng, reqs, slots=4)
        assert rep["finished"] == 3 and rep["compiles_after_warmup"] == 0
        assert rep["kv_dtype"] == "fp32" and rep["spec"]["drafted_tokens"] > 0
        streams[ddt] = [r.tokens for r in reqs]
        spec[ddt] = rep["spec"]
    assert streams["int8"] == streams["fp32"]
    assert spec["int8"]["drafted_tokens"] == spec["fp32"]["drafted_tokens"]
    assert spec["int8"]["accepted_tokens"] == spec["fp32"]["accepted_tokens"]


def test_int8_pool_spec_stream_matches_int8_plain_stream(smoke):
    """int8 pages under speculation: the verify lane runs B4's path and the
    greedy stream equals the int8 pool's plain greedy stream."""
    _, tcfg, _, tparams = smoke
    out = {}
    for k in (0, 2):
        reqs = _prompt_reqs(tcfg.vocab_size, prompt_len=12, new_tokens=6)
        with _engine(tcfg, tparams, spec_k=k, kv_dtype="int8",
                     draft_kv_dtype="int8") as eng:
            rep = run_paged_stream(eng, reqs, slots=4)
        assert rep["finished"] == 3 and rep["compiles_after_warmup"] == 0
        out[k] = [r.tokens for r in reqs]
    assert rep["lane_steps"]["verify"] > 0
    assert out[2] == out[0]


def test_launcher_serves_int8_spec_on_the_cpu():
    rep = launch.main([
        "--smoke", "--device", "cpu", "--requests", "6", "--rate", "500",
        "--tokens-mean", "6", "--max-len", "64", "--page-size", "8",
        "--prefix-len", "16", "--prefill-chunk", "16", "--sample-frac", "0",
        "--kv-dtype", "int8", "--spec-k", "4", "--json",
    ])
    assert rep["finished"] == 6 and rep["compiles_after_warmup"] == 0
    assert rep["kv_dtype"] == "int8" and rep["spec_k"] == 4
    assert rep["lane_steps"]["draft"] > 0 and rep["lane_steps"]["verify"] > 0
