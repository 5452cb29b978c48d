"""Batchers of one engine keep their own storage (ROADMAP C13).

The JAX engine builds fresh caches for every batcher, so two batchers on
one JAX engine never see each other. The port's targets are bound to the
engine's one page pool per dtype and one dense cache per slot count (on the
card they are captured over them), so a new batcher of a key parks the
resident batcher's state before it zeroes and warms, and each step puts the
caller's state back (``serve._StorageBank``). Here a first batcher serves a
stream (olmo-1b smoke, fp32, the JAX weights, a quarter sampled) while a
second batcher is built at its third iteration: of the same pool dtype, of
another dtype, a dense one of the same slot count, and one of the same key
that then serves a stream of its own in turn. Each batcher's tokens, steps
and lane calls equal the JAX package's under the same schedule of builds
and steps. The same cases run through targets whose capture is
emulated on the CPU, where a replay writes the target's static inputs as a
CUDA graph's does. Tolerance: exact.
"""

from __future__ import annotations

import pytest

from repro_torch.configs import get_config
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime import serve as tserve
from test_torch_faults import jaxpkg, tparams  # noqa: F401 (fixtures)
from test_torch_graphs import _emulated
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

ENGINE = dict(max_len=32, batch_quantum=2, max_batch=4, page_size=8,
              num_pages=20, prefill_chunk=16, kv_dtypes=("int8",))
SLOTS = 4
BUILD_AT = 3  # the iteration at which the second batcher is built


def _traffic(sched, vocab: int, seed: int) -> list:
    return sched.shared_prefix_arrivals(
        6, 400.0, seed=seed, num_prefixes=2, prefix_len=12, tokens_mean=6.0,
        total_max=32, sample_frac=0.25, vocab=vocab,
    )


def _paged(kv_dtype=None, seed=0):
    return lambda eng: eng.paged_continuous(slots=SLOTS, kv_dtype=kv_dtype,
                                            seed=seed)


def _dense(seed=0):
    return lambda eng: eng.continuous(slots=SLOTS, seed=seed)


def _drive(eng, runs: list) -> list:
    """``runs``: (build, requests, build iteration) per batcher. Each is
    built at its iteration, then every iteration admits what fits and steps
    it if it has work, so each batcher sees the same calls whatever runs
    beside it. Returns (tokens by rid, steps, lane calls) per batcher; a
    batcher given no requests is built and never stepped."""
    live: list = []
    it = 0
    while it < max(at for _, _, at in runs) or any(
        todo or b.has_work for b, todo in live
    ):
        it += 1
        assert it < 400, "stream wedged"
        live += [(build(eng), list(reqs)) for build, reqs, at in runs
                 if at == it]
        for b, todo in live:
            take = todo[:b.free_slots]
            del todo[:len(take)]
            if take:
                back = b.admit(take, now=float(it))
                todo[:0] = take[back:] if isinstance(back, int) else back
            if b.has_work:
                b.step(now=float(it))
            todo.extend(getattr(b, "preempted", ()))
            if hasattr(b, "preempted"):
                b.preempted.clear()
    out = []
    for (b, _), (_, reqs, _) in zip(live, runs):
        b.flush(float(it + 1))
        out.append(({r.rid: r.tokens for r in reqs}, b.stats.steps,
                     {k: n for k, n in b.stats.lane_calls.items() if n}))
    return out


CASES = {
    # first batcher, second batcher, does the second serve a stream?
    "paged, then paged of its dtype": ("paged", _paged(), False),
    "paged, then paged int8": ("paged", _paged("int8"), False),
    "dense, then dense of its slots": ("dense", _dense(), False),
    "paged and paged of one key, in turn": ("paged", _paged(seed=1), True),
}


def _runs(sched, vocab: int, case: str) -> list:
    first, second, serves = CASES[case]
    return [(_paged() if first == "paged" else _dense(),
             _traffic(sched, vocab, 3), 1),
            (second, _traffic(sched, vocab, 4) if serves else [], BUILD_AT)]


@pytest.fixture(scope="module")
def jax_runs(jaxpkg):  # noqa: F811
    """Each case on one JAX engine of the module, computed once."""
    jaxpkg["reset"]()
    eng = jaxpkg["serve"].Engine(jaxpkg["cfg"], jaxpkg["params"],
                                 jaxpkg["serve"].EngineConfig(**ENGINE))
    done: dict = {}

    def run(case: str) -> list:
        if case not in done:
            done[case] = _drive(eng, _runs(jaxpkg["sched"],
                                           jaxpkg["cfg"].vocab_size, case))
        return done[case]

    yield run
    eng.close()


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graphs"])
@pytest.mark.parametrize("case", list(CASES))
def test_second_batcher_leaves_the_first_as_jax(jax_runs, tparams,  # noqa: F811
                                                monkeypatch, case, graphs):
    cfg = get_config("olmo-1b").smoke()
    with tserve.Engine(cfg, tparams, tserve.EngineConfig(**ENGINE),
                       device="cpu") as eng:
        if graphs:
            _emulated(monkeypatch, eng)
        got = _drive(eng, _runs(tsched, cfg.vocab_size, case))
        assert eng.post_warmup_compiles == 0
    assert got == jax_runs(case)
    assert sum(map(len, got[0][0].values())) > 0
