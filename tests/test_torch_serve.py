"""The port's paged serving stream against the JAX package's.

The same greedy shared-prefix stream, with chunked prefill, on identical
weights (``params_from_jax``) through ``repro.runtime.serve.run_paged_stream``
and ``repro_torch.runtime.serve.run_paged_stream``. Streams are matched by
``rid`` (wall-clock admission may batch requests differently in the two
runs) and must be equal token for token, except that at a first divergence
the JAX logits' top-2 margin there must be below the logit tolerance 1e-4 (a
near-tie that float reassociation may flip).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_config as jax_config
from repro.core import reset_entry_points
from repro.runtime import scheduler as jsched
from repro.runtime import serve as jserve
from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.lanes import UnknownLaneError
from repro_torch.core.telemetry import Telemetry
from repro_torch.launch import serve as launch
from repro_torch.runtime.scheduler import shared_prefix_arrivals
from repro_torch.runtime.serve import Engine, EngineConfig, run_paged_stream

LOGIT_TOL = 1e-4
ENGINE = dict(max_len=64, max_batch=4, page_size=8, num_pages=40)
TRAFFIC = dict(seed=1, num_prefixes=3, prefix_len=20, tokens_mean=6,
               total_max=64, sample_frac=0.0, vocab=256)


@pytest.fixture(scope="module")
def smoke():
    cfg = jax_config("olmo-1b").smoke()
    jparams = jm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return cfg, get_config("olmo-1b").smoke(), jparams, tparams


def _port_stream(tcfg, tparams, reqs, **ecfg):
    with Engine(tcfg, tparams, EngineConfig(**{**ENGINE, **ecfg}),
                device="cpu") as eng:
        return run_paged_stream(eng, reqs, slots=4)


def _near_tie(cfg, jparams, req, upto: int) -> bool:
    """Top-2 margin of the JAX logits that chose ``req.tokens[upto]``."""
    seq = list(req.prompt) + req.tokens[:upto]
    logits, _ = jm.forward(cfg, jparams, jax.numpy.asarray([seq], np.int32))
    top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top2[1] - top2[0]) < LOGIT_TOL


def test_stream_matches_jax(smoke):
    cfg, tcfg, jparams, tparams = smoke
    jreqs = jsched.shared_prefix_arrivals(12, 1000.0, **TRAFFIC)
    treqs = shared_prefix_arrivals(12, 1000.0, **TRAFFIC)
    assert [r.prompt for r in jreqs] == [r.prompt for r in treqs]

    reset_entry_points()
    jeng = jserve.Engine(cfg, jparams, jserve.EngineConfig(
        batch_quantum=2, prefill_chunk=16, **ENGINE))
    try:
        jrep = jserve.run_paged_stream(jeng, jreqs, slots=4)
    finally:
        jeng.close()
    trep = _port_stream(tcfg, tparams, treqs, prefill_chunk=16)

    assert trep["finished"] == jrep["finished"] == len(treqs)
    assert trep["compiles_after_warmup"] == 0
    assert trep["prefill_chunks"] > 0
    jstreams = {r.rid: r for r in jreqs}
    for r in treqs:
        jr = jstreams[r.rid]
        diff = [i for i, (a, b) in enumerate(zip(r.tokens, jr.tokens)) if a != b]
        if diff:
            assert _near_tie(cfg, jparams, jr, diff[0]), (r.rid, diff[0])
        else:
            assert r.tokens == jr.tokens, r.rid


def test_chunked_and_token_by_token_streams_agree(smoke):
    """Chunked prefill emits what token-by-token forcing emits, in fewer
    steps, with zero builds after warmup either way."""
    _, tcfg, _, tparams = smoke
    chunked = shared_prefix_arrivals(8, 1000.0, **TRAFFIC)
    forced = shared_prefix_arrivals(8, 1000.0, **TRAFFIC)
    rc = _port_stream(tcfg, tparams, chunked, prefill_chunk=16)
    rf = _port_stream(tcfg, tparams, forced, prefill_chunk=0)
    assert rc["compiles_after_warmup"] == rf["compiles_after_warmup"] == 0
    assert rc["steps"] < rf["steps"] and rf["prefill_chunks"] == 0
    assert {r.rid: r.tokens for r in chunked} == {r.rid: r.tokens for r in forced}


def test_plain_attention_serves_the_same_greedy_stream(smoke):
    _, tcfg, _, tparams = smoke
    a = shared_prefix_arrivals(8, 1000.0, **TRAFFIC)
    b = shared_prefix_arrivals(8, 1000.0, **TRAFFIC)
    ra = _port_stream(tcfg, tparams, a, prefill_chunk=16, attn_impl="kernel")
    rb = _port_stream(tcfg, tparams, b, prefill_chunk=16, attn_impl="plain")
    assert (ra["attn_impl"], rb["attn_impl"]) == ("kernel", "plain")
    assert {r.rid: r.tokens for r in a} == {r.rid: r.tokens for r in b}


def test_sampled_rows_follow_the_batcher_seed(smoke):
    _, tcfg, _, tparams = smoke
    runs = []
    for _ in range(2):
        reqs = shared_prefix_arrivals(6, 1000.0, **{**TRAFFIC, "sample_frac": 1.0})
        with Engine(tcfg, tparams, EngineConfig(**ENGINE, prefill_chunk=16),
                    device="cpu") as eng:
            rep = run_paged_stream(eng, reqs, slots=4, seed=5)
        assert rep["finished"] == len(reqs)
        runs.append({r.rid: r.tokens for r in reqs})
    assert runs[0] == runs[1]
    assert all(0 <= t < tcfg.vocab_size for ts in runs[0].values() for t in ts)


def test_engine_runs_on_the_gpu_by_default(smoke):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, tcfg, _, tparams = smoke
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(tcfg, tparams, EngineConfig(**ENGINE))


def test_unknown_lane_raises(smoke):
    _, tcfg, _, tparams = smoke
    with Engine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu") as eng:
        with pytest.raises(UnknownLaneError):
            eng._build(("cb", 4))
        with pytest.raises(UnknownLaneError):
            eng._build(("cbp", 4))  # missing the pages_bucket coordinate
        with pytest.raises(UnknownLaneError):
            eng._build(("cbp", 4, 2))  # missing the kv_dtype coordinate


def test_branch_target_rejects_other_shapes(smoke):
    _, tcfg, _, tparams = smoke
    with Engine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu") as eng:
        step = eng._build(("cbp", 4, 2, "fp32"))
        cache = tm.init_paged_cache(tcfg, eng.pool_physical_pages, 8)
        z = torch.zeros
        with pytest.raises(ValueError, match="block_tables"):
            step(cache, z(4, 1, dtype=torch.int32), z(4, dtype=torch.int32),
                 z(4, 3, dtype=torch.int32), z(4, dtype=torch.bool),
                 torch.ones(4), torch.ones(4, dtype=torch.bool),
                 torch.Generator())


def test_launcher_serves_on_the_cpu():
    rep = launch.main([
        "--smoke", "--device", "cpu", "--requests", "6", "--rate", "500",
        "--tokens-mean", "4", "--max-len", "64", "--page-size", "8",
        "--prefix-len", "16", "--prefill-chunk", "16", "--json",
    ])
    assert rep["finished"] == 6 and rep["compiles_after_warmup"] == 0
    assert rep["prefill_chunks"] > 0 and rep["device"] == "cpu"


def test_flight_recorder_traces_the_stream(smoke):
    """With recording on, the warm boundary, admissions, lane calls, d2h
    pulls and finishes land in the ring; the metrics registry rolled its
    warmup section over at the boundary."""
    _, tcfg, _, tparams = smoke
    tel = Telemetry(enabled=True)
    reqs = shared_prefix_arrivals(4, 1000.0, **TRAFFIC)
    with Engine(tcfg, tparams, EngineConfig(**ENGINE, prefill_chunk=16),
                telemetry=tel, device="cpu") as eng:
        rep = run_paged_stream(eng, reqs, slots=4)
    names = {e.name for e in tel.recorder.events()}
    assert {"warm_boundary", "admit", "lane_step", "d2h", "finish"} <= names
    assert "warmup" in tel.registry.sections
    assert rep["lane_calls"] == {"pf": rep["lane_steps"]["prefill"],
                                 "cbp": rep["lane_steps"]["decode"]}


def test_pool_pressure_defers_and_preempts_without_changing_streams(smoke):
    """A pool too small for every seated request: admissions defer and
    lower-priority requests are preempted and restarted, yet every request
    finishes with the tokens an ample pool gives it."""
    _, tcfg, _, tparams = smoke
    kw = {**TRAFFIC, "tokens_mean": 12}
    tight = shared_prefix_arrivals(8, 1000.0, **kw)
    ample = shared_prefix_arrivals(8, 1000.0, **kw)
    rt = _port_stream(tcfg, tparams, tight, prefill_chunk=16, num_pages=16)
    ra = _port_stream(tcfg, tparams, ample, prefill_chunk=16)
    assert rt["finished"] == ra["finished"] == 8
    assert rt["preemptions"] + rt["starved_admissions"] > 0
    assert rt["compiles_after_warmup"] == 0
    assert {r.rid: r.tokens for r in tight} == {r.rid: r.tokens for r in ample}
