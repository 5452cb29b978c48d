"""The port's async step pipeline (DESIGN.md §13, ``async_steps``) against
its synchronous loop and against the JAX package's pipeline (the twin of
``tests/test_async.py``).

Both batchers, speculation off and at ``spec_k`` 3, on ``olmo-1b``'s smoke
config (fp32, the JAX package's weights), a half-sampled stream under one
step clock: the port's async stream equals its synchronous one in greedy
tokens (the pipeline's invariant; a sampled row's keys split once per
step, and async admits on other steps) and builds no key sync does not;
it equals the JAX package's async stream in every token, sampled ones
too, and in ``steps``, ``lane_calls``, ``inflight_depth`` and
``d2h_transfers``. The same async streams run through targets whose
capture is emulated on the CPU (``test_torch_graphs.py``: a replay reruns
the step and clobbers every other target's static outputs) and equal the
eager async streams: a parked step's pull is taken at issue, not at
commit. Then the rollback replay (a spec step's accept/rollback one step
late, every committed token and the accept counts as the synchronous
loop's), the pipeline's telemetry and spans (``async_issue``,
``async_park``, ``async_commit``), and ``flush``.

``cuda``-marked (skipped here): the async paged stream through CUDA-graph
targets on the card equals the synchronous one with no capture after
warmup.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.telemetry import Telemetry
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.serve import (
    Engine,
    EngineConfig,
    run_continuous_stream,
    run_paged_stream,
)
from test_torch_continuous import StepClock
from test_torch_graphs import _emulated

ENGINE = dict(max_len=48, batch_quantum=2, max_batch=4, page_size=8,
              num_pages=40, prefill_chunk=8)
SLOTS = 4
KINDS = {"dense": "continuous", "paged": "paged"}


def _traffic(sched, kind: str, vocab: int) -> list:
    """Eight requests at 2000 req/s over four slots (decode-heavy,
    admissions overlap run-ahead), half sampled; prompts longer than a
    chunk, so non-flip chunks park."""
    if kind == "dense":
        reqs = sched.poisson_arrivals(8, 2000.0, seed=0, tokens_mean=8.0,
                                      tokens_max=20, sample_frac=0.5,
                                      vocab=vocab)
        return sched.attach_distinct_prompts(reqs, 12, vocab=vocab, seed=1)
    return sched.shared_prefix_arrivals(
        8, 2000.0, seed=0, num_prefixes=2, prefix_len=20, tokens_mean=6.0,
        total_max=48, sample_frac=0.5, vocab=vocab,
    )


@pytest.fixture(scope="module")
def smoke():
    jax = pytest.importorskip("jax")
    from repro import models as jm
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax

    cfg = jax_config("olmo-1b").smoke()
    jparams = jm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return cfg, get_config("olmo-1b").smoke(), jparams, tparams


@pytest.fixture(scope="module")
def jax_async(smoke):
    """The JAX package's async stream per (kind, spec_k), once a module."""
    from repro.core import reset_entry_points
    from repro.runtime import scheduler as jsched
    from repro.runtime import serve as jserve

    cfg, _, jparams, _ = smoke
    done: dict = {}

    def get(kind: str, spec_k: int):
        if (kind, spec_k) not in done:
            reset_entry_points()
            reqs = _traffic(jsched, kind, cfg.vocab_size)
            eng = jserve.Engine(cfg, jparams,
                                jserve.EngineConfig(**ENGINE, spec_k=spec_k))
            run = getattr(jserve, f"run_{KINDS[kind]}_stream")
            try:
                rep = run(eng, reqs, slots=SLOTS, clock=StepClock(),
                          async_steps=True)
            finally:
                eng.close()
            done[kind, spec_k] = (reqs, rep)
        return done[kind, spec_k]

    return get


def _port(smoke, kind: str, spec_k: int, async_steps: bool,
          monkeypatch=None) -> tuple:
    """One port stream; with ``monkeypatch``, through emulated graphs."""
    _, tcfg, _, tparams = smoke
    reqs = _traffic(tsched, kind, tcfg.vocab_size)
    run = run_continuous_stream if kind == "dense" else run_paged_stream
    with Engine(tcfg, tparams, EngineConfig(**ENGINE, spec_k=spec_k),
                device="cpu") as eng:
        if monkeypatch is not None:
            _emulated(monkeypatch, eng)
        rep = run(eng, reqs, slots=SLOTS, clock=StepClock(),
                  async_steps=async_steps)
        keys = set(eng._decode.cache._table)
    return reqs, rep, keys


def _pipeline(rep: dict) -> tuple:
    p = rep["pipeline"]
    return (rep["steps"], rep["lane_calls"], p["inflight_depth"],
            p["d2h_transfers"])


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("spec_k", [0, 3])
def test_async_matches_sync_and_the_jax_pipeline(smoke, jax_async, kind,
                                                 spec_k):
    sreqs, srep, skeys = _port(smoke, kind, spec_k, False)
    areqs, arep, akeys = _port(smoke, kind, spec_k, True)
    jreqs, jrep = jax_async(kind, spec_k)
    assert srep["finished"] == arep["finished"] == len(areqs)
    assert {r.rid: r.tokens for r in sreqs if r.greedy} == {
        r.rid: r.tokens for r in areqs if r.greedy}
    assert arep["compiles_after_warmup"] == 0 and akeys == skeys
    assert arep["async_steps"] and arep["pipeline"]["async_steps"]
    assert not srep["async_steps"] and srep["pipeline"]["inflight_depth"] == 0
    # the JAX package's async stream: every token, sampled ones too
    assert not all(r.greedy for r in areqs)
    assert [r.tokens for r in areqs] == [r.tokens for r in jreqs]
    assert _pipeline(arep) == _pipeline(jrep)
    # spec steps park one at a time (their commit precedes the next plan);
    # chainable decodes and parked chunks run ahead
    assert arep["pipeline"]["inflight_depth"] >= (1 if spec_k else 2)
    if spec_k:
        assert arep["lane_calls"]["vf" if kind == "paged" else "vfd"] > 0
        for key in ("drafted_tokens", "accepted_tokens"):
            assert arep["spec"][key] == jrep["spec"][key], key
    else:
        assert arep["prefill_chunks"] == jrep["prefill_chunks"] > 0


@pytest.mark.parametrize("kind, spec_k", [("dense", 0), ("paged", 3)])
def test_async_through_emulated_graphs_equals_eager(smoke, monkeypatch,
                                                    kind, spec_k):
    """Parked steps hold their pulls across later replays that clobber
    every static output in the pool; uploads land in the static inputs."""
    greqs, grep, gkeys = _port(smoke, kind, spec_k, True, monkeypatch)
    monkeypatch.undo()
    ereqs, erep, _ = _port(smoke, kind, spec_k, True)
    assert [r.tokens for r in greqs] == [r.tokens for r in ereqs]
    assert _pipeline(grep) == _pipeline(erep)
    assert grep["cuda_graphs"] and grep["compiles_after_warmup"] == 0


def _dense_batcher(smoke, spec_k: int, async_steps: bool, telemetry=None):
    _, tcfg, _, tparams = smoke
    eng = Engine(tcfg, tparams,
                 EngineConfig(**{**ENGINE, "prefill_chunk": 0},
                              spec_k=spec_k),
                 telemetry=telemetry, device="cpu")
    return eng, eng.continuous(slots=SLOTS, async_steps=async_steps)


def test_rollback_replay_matches_synchronous_spec(smoke):
    """Under async a spec step's accept/rollback lands a step late and is
    replayed against the parked drafts: rejections occur, and every
    committed token and the accept counts equal the synchronous loop's."""
    stats, toks = {}, {}
    for mode in (False, True):
        eng, cb = _dense_batcher(smoke, 3, mode)
        with eng:
            reqs = [Request(rid=i, new_tokens=14, greedy=True,
                            first_token=7 * i + 3) for i in range(4)]
            cb.admit(reqs, now=0.0)
            while cb.has_work:
                cb.step(0.0)
            cb.flush(0.0)
            assert cb.stats.drafted_tokens > 0
            assert cb.stats.accepted_tokens < cb.stats.drafted_tokens
            stats[mode] = (cb.stats.accepted_tokens, cb.stats.drafted_tokens)
            toks[mode] = [list(r.tokens) for r in reqs]
    assert toks[False] == toks[True]
    assert stats[False] == stats[True]


def test_async_pipeline_telemetry_and_spans(smoke):
    """A decode-heavy async stream pipelines: in-flight depth 2, one pull
    per step (as the synchronous loop, which packs its pull too — the JAX
    package's takes three), and the pipeline's spans in the flight
    recorder."""
    d2h = {}
    for mode in (False, True):
        tel = Telemetry(enabled=True)
        eng, cb = _dense_batcher(smoke, 0, mode, tel)
        with eng:
            reqs = [Request(rid=i, new_tokens=20, greedy=True,
                            first_token=i + 1) for i in range(4)]
            cb.admit(reqs, now=0.0)
            while cb.has_work:
                cb.step(0.0)
            cb.flush(0.0)
            d2h[mode] = (cb.stats.d2h_transfers, cb.stats.steps)
            names = {e.name for e in tel.recorder.events()}
            spans = {"async_issue", "async_park", "async_commit"}
            if mode:
                assert cb.stats.inflight_depth == 2
                assert cb.stats.host_plan_ms > 0.0
                assert spans <= names and "d2h" in names
                report = tsched.latency_report(reqs, batcher=cb)
                assert report["pipeline"]["async_steps"] is True
            else:
                assert not spans & names
    assert d2h[False] == (20, 20)
    # run-ahead issues one step past the last token (the reference's too)
    assert d2h[True] == (21, 21)


def test_flush_commits_inflight_step(smoke):
    """A stream that ends mid-pipeline keeps the parked step's tokens:
    ``flush`` commits it and returns the finished request."""
    eng, cb = _dense_batcher(smoke, 0, True)
    with eng:
        req = Request(rid=0, new_tokens=5, greedy=True, first_token=11)
        cb.admit([req], now=0.0)
        finished = []
        for _ in range(5):  # the 5th token is parked
            finished.extend(cb.step(0.0))
        assert req not in finished and cb.has_work
        finished.extend(cb.flush(0.0))
        assert req in finished and len(req.tokens) == 5
        assert not cb.has_work and cb.flush(0.0) == []


def test_launcher_takes_the_async_flags(capsys):
    from repro_torch.launch import serve as launch

    rep = launch.main(["--engine", "paged", "--smoke", "--device", "cpu",
                       "--requests", "6", "--max-len", "64", "--page-size",
                       "8", "--prefix-len", "16", "--prefill-chunk", "16",
                       "--async-steps", "--async-depth", "3", "--json"])
    assert rep["finished"] == 6 and rep["async_steps"] is True
    assert rep["compiles_after_warmup"] == 0
    assert rep["pipeline"]["inflight_depth"] >= 2
    with pytest.raises(SystemExit):
        launch.main(["--smoke", "--device", "cpu", "--async-depth", "0"])
    assert "--async-depth must be >= 1" in capsys.readouterr().err


@pytest.mark.cuda
def test_cuda_async_paged_stream_equals_sync():
    """On the card (no JAX needed): CUDA-graph targets, parked pulls into
    pinned buffers, staged uploads; greedy tokens equal the synchronous
    stream's, no capture after warmup."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import models
    from repro_torch.configs import get_config

    tcfg = get_config("olmo-1b").smoke()
    tparams = models.init_params(tcfg, seed=0)
    out = {}
    for mode in (False, True):
        reqs = _traffic(tsched, "paged", tcfg.vocab_size)
        with Engine(tcfg, tparams, EngineConfig(**ENGINE, spec_k=3)) as eng:
            rep = run_paged_stream(eng, reqs, slots=SLOTS, clock=StepClock(),
                                   async_steps=mode)
        assert rep["cuda_graphs"] and rep["compiles_after_warmup"] == 0
        out[mode] = ({r.rid: r.tokens for r in reqs if r.greedy}, rep)
    assert out[False][0] == out[True][0]
    assert out[True][1]["pipeline"]["inflight_depth"] >= 2
