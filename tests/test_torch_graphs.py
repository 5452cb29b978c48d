"""CUDA-graph branch targets (``repro_torch.core.graph_target``) and the
engine's graph lanes.

On the CPU: ``GraphTarget``'s guard (a wrong dtype, a broadcastable shape or
the wrong device raises before any copy), its chained and owned outputs,
``cuda_graphs=True`` refused on a CPU engine, the eager targets' dtype
guard, and the serving streams through targets whose capture is emulated —
a replay reruns the step into the static outputs and overwrites every
other target's static outputs in the pool, as a shared graph pool may —
equal to the eager streams token for token (greedy and sampled, bf16 and
int8 pages, speculation, both burst families). That holds the scheduler to
the graphs' contract: inputs land in the static inputs, chained outputs are
adopted, every other output is read before the next replay.

Marked ``cuda`` (they skip here): each lane's captured target against its
eager step on the card, zero captures after warmup, sampled tokens equal to
eager for one seed, launch counts under replay, a failed capture raising,
and ``BranchChanger`` over graphs.
"""

from __future__ import annotations

import pytest
import torch
from torch.utils import _pytree as pytree

import repro_torch.core as tcore
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.core import lanes
from repro_torch.core.graph_target import GraphTarget, check_args
from repro_torch.runtime import serve
from repro_torch.runtime.scheduler import (
    poisson_arrivals,
    shared_prefix_arrivals,
)
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _clean_registry():
    tcore.reset_entry_points()
    yield
    tcore.reset_entry_points()


class _EmulatedGraph(GraphTarget):
    """``GraphTarget`` with its capture emulated on the CPU: capture runs
    the step (warmup, then the "capture"); a replay reruns it into the
    static outputs, then overwrites the static outputs of every other
    target that shares the pool."""

    def capture(self):
        for _ in range(2):
            out = self._run()
        self._result = self._bind_outputs(out)
        pool = self._pool if self._pool is not None else []
        pool.append(self)

        def replay():
            out = self._run()
            if isinstance(out, tuple) and self.owned is not None:
                out = tuple(None if o is self.owned else o for o in out)
            for s, n in zip(self.static_outputs, pytree.tree_leaves(out)):
                if isinstance(s, torch.Tensor):
                    s.copy_(n)
            for other in pool:
                for s in other.static_outputs if other is not self else ():
                    if isinstance(s, torch.Tensor):
                        s.fill_(True if s.dtype == torch.bool else -7)

        self.graph = type("Replay", (), {"replay": staticmethod(replay)})()
        return self


class _StepClock:
    """Virtual time that advances a fixed step per read: the stream forms
    the same batches whichever targets run it."""

    def __init__(self, dt: float = 0.004) -> None:
        self.t = 0.0
        self.dt = dt

    def now(self) -> float:
        self.t += self.dt
        return self.t

    def jump_to(self, t: float) -> None:
        self.t = max(self.t, t)


# ------------------------------------------------------------------ guard
def _target(pool=None, chain=None, owned=None):
    state = torch.zeros(3)

    def step(x, n):
        state.add_(x)  # state the step owns, updated in place
        return x * 2, owned, n + 1

    g = _EmulatedGraph(
        step, [torch.ones(3), torch.zeros((), dtype=torch.int32)],
        owned=owned, pool=pool, chain=chain, names=["x", "n"], name="t",
    )
    return g.capture(), state


@pytest.mark.parametrize("bad, match", [
    (torch.ones(3, dtype=torch.float64), "x: expected"),
    (torch.ones(1), "x: expected \\(3,\\)"),  # copy_ would broadcast it
    (torch.ones(3, device="meta"), "on meta"),
])
def test_guard_raises_before_any_copy(bad, match):
    g, _ = _target()
    before = g.static_inputs[0].clone()
    with pytest.raises(ValueError, match=match):
        g(bad, torch.zeros((), dtype=torch.int32))
    assert torch.equal(g.static_inputs[0], before) and g.replays == 0
    with pytest.raises(ValueError, match="expected 2 inputs"):
        g(torch.ones(3))
    with pytest.raises(ValueError, match="n: expected a tensor"):
        g(torch.ones(3), 1)


def test_replay_copies_in_only_what_is_not_static():
    g, state = _target(owned=["the cache"])
    x = torch.arange(3.0)
    out = g(x, torch.tensor(4, dtype=torch.int32))
    assert torch.equal(out[0], x * 2) and int(out[2]) == 5
    assert out[1] is g.owned  # the owned state comes back as itself
    assert out[0] is g.static_outputs[0]
    assert g.out_signature == (((3,), torch.float32), None,
                               ((), torch.int32))
    g(*g.static_inputs)  # nothing to copy in
    assert torch.equal(g.static_inputs[0], x) and g.replays == 2
    assert torch.equal(state, 2 * 1.0 + 2 * x)  # 2 captures' runs + 2 calls


def test_chained_output_returns_the_static_input():
    g, _ = _target(chain={2: 1})
    n = torch.zeros((), dtype=torch.int32)
    for want in (1, 2, 3):
        out = g(torch.ones(3), n)
        n = out[2]
        assert n is g.static_inputs[1] and int(n) == want
    with pytest.raises(ValueError, match="chained output 0"):
        _target(chain={0: 1})


def test_capture_needs_a_cuda_device():
    g = GraphTarget(lambda x: x + 1, [torch.ones(2)], name="cpu-step")
    with pytest.raises(ValueError, match="capture CUDA tensors"):
        g.capture()
    with pytest.raises(RuntimeError, match="capture\\(\\) before calling"):
        g(torch.ones(2))
    with pytest.raises(ValueError, match="tensor inputs"):
        GraphTarget(lambda: 0, [])


def test_check_args_is_exact():
    specs = [("tok", (2, 1), torch.int32)]
    check_args(specs, [torch.zeros(2, 1, dtype=torch.int32)],
               torch.device("cpu"))
    with pytest.raises(ValueError, match="tok: expected"):
        check_args(specs, [torch.zeros(2, 1, dtype=torch.int64)],
                   torch.device("cpu"))


# ------------------------------------------------------------ the engine
@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("olmo-1b").smoke()
    return cfg, models.init_params(cfg, seed=0)


ENGINE = dict(max_len=64, max_batch=4, page_size=8, num_pages=40,
              prefill_chunk=16)


def test_cuda_graphs_true_on_a_cpu_engine_raises(smoke):
    cfg, params = smoke
    with pytest.raises(ValueError, match="cuda_graphs=True"):
        serve.Engine(cfg, params, serve.EngineConfig(cuda_graphs=True),
                     device="cpu")
    with serve.Engine(cfg, params, serve.EngineConfig(**ENGINE),
                      device="cpu") as eng:
        assert eng.graphs is False
        step = eng._build(lanes.CBP.key(4, 2, "fp32", "1x1"))
        assert not hasattr(step, "static_inputs")  # the eager target


def test_eager_target_checks_every_input_dtype(smoke):
    """The guard of a CPU target covers dtype as well as shape and device."""
    cfg, params = smoke
    with serve.Engine(cfg, params, serve.EngineConfig(**ENGINE),
                      device="cpu") as eng:
        step = eng._build(lanes.CBP.key(4, 2, "fp32", "1x1"))
        cache = eng.paged_cache("fp32")
        z = torch.zeros
        rows = [z(4, 1, dtype=torch.int32), z(4, dtype=torch.int32),
                z(4, 2, dtype=torch.int32), z(4, dtype=torch.bool),
                torch.ones(4), torch.ones(4, dtype=torch.bool),
                z(4, 2, dtype=torch.int32)]
        for i, name in enumerate(("tok", "pos", "block_tables", "active",
                                  "temps", "greedy", "keys")):
            bad = list(rows)
            bad[i] = bad[i].to(torch.float64)
            with pytest.raises(ValueError, match=f"{name}: expected"):
                step(cache, *bad)
        out = step(cache, *rows)
        assert out[0].shape == (4,) and out[1] is cache
        assert out[3].shape == (4, 2) and out[5].shape == (4, 4)


def _emulated(monkeypatch, eng):
    """Turn a CPU engine's targets into emulated graphs."""
    monkeypatch.setattr(serve, "GraphTarget", _EmulatedGraph)
    eng.graphs = True
    eng._graph_pool = []


def _paged_tokens(smoke, monkeypatch, graphs, **ecfg):
    cfg, params = smoke
    reqs = shared_prefix_arrivals(
        12, 300.0, seed=2, num_prefixes=3, prefix_len=20, tokens_mean=8,
        total_max=64, sample_frac=0.3, vocab=cfg.vocab_size,
    )
    with serve.Engine(cfg, params, serve.EngineConfig(**ENGINE, **ecfg),
                      device="cpu") as eng:
        if graphs:
            _emulated(monkeypatch, eng)
        rep = serve.run_paged_stream(eng, reqs, slots=4, clock=_StepClock())
        kinds = {type(t).__name__ for t in eng._decode.cache._table.values()}
    assert rep["finished"] == 12 and rep["compiles_after_warmup"] == 0
    return {r.rid: r.tokens for r in reqs}, rep, kinds


@pytest.mark.parametrize("ecfg", [
    dict(spec_k=2),
    dict(kv_dtype="int8", spec_k=2, draft_kv_dtype="int8"),
], ids=["fp32+spec", "int8+spec"])
def test_paged_stream_through_emulated_graphs_equals_eager(
    smoke, monkeypatch, ecfg
):
    toks, rep, kinds = _paged_tokens(smoke, monkeypatch, True, **ecfg)
    monkeypatch.undo()
    want, wrep, _ = _paged_tokens(smoke, monkeypatch, False, **ecfg)
    assert kinds == {"_GraphStep"}
    assert toks == want
    assert rep["lane_steps"] == wrep["lane_steps"]
    assert rep["h2d_uploads"] == wrep["h2d_uploads"]
    assert rep["lane_steps"]["verify"] > 0 and rep["cuda_graphs"]


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m"])
def test_burst_stream_through_emulated_graphs_equals_eager(
    monkeypatch, arch
):
    cfg = get_config(arch).smoke()
    params = models.init_params(cfg, seed=0)
    out = {}
    for graphs in (True, False):
        reqs = poisson_arrivals(12, 50.0, seed=4, tokens_mean=8,
                                tokens_max=32, sample_frac=0.3,
                                vocab=cfg.vocab_size)
        with serve.Engine(cfg, params, serve.EngineConfig(
            max_len=32, max_batch=8, batch_quantum=4), device="cpu"
        ) as eng:
            if graphs:
                _emulated(monkeypatch, eng)
            rep = serve.run_burst_stream(eng, reqs, clock=_StepClock())
            if graphs:
                b = rep and next(iter(eng._burst_caches))
                with pytest.raises(ValueError, match="burst_cache"):
                    eng.decode_loop(models.init_cache(cfg, b, 32),
                                    torch.zeros(b, 1, dtype=torch.int32),
                                    0, 1)
        monkeypatch.undo()
        out[graphs] = ({r.rid: r.tokens for r in reqs},
                       rep["compiles_after_warmup"], rep["mode_switches"])
    assert out[True] == out[False]


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fill(cache, seed):
    """Random cache contents: K/V values (int8 codes for int8 pages),
    positive scales."""
    g = torch.Generator().manual_seed(seed)
    for slot in cache:
        for t in slot.values():
            if t.dtype == torch.int8:
                src = torch.randint(-127, 128, t.shape, generator=g)
            elif t.dim() == 3:  # per-row scales [m, P, page_size]
                src = torch.rand(t.shape, generator=g) * 0.02 + 1e-3
            else:
                src = torch.randn(t.shape, generator=g)
            t.copy_(src.to(t.dtype))


def _lane_inputs(key, eng, seed):
    """Inputs of a lane key: valid tables, live positions, mixed modes."""
    g = torch.Generator().manual_seed(seed)
    lane, coords = key.lane, key.coords
    s = coords[0]
    dev = eng.device
    i32 = torch.int32
    vocab = eng.cfg.vocab_size

    def toks(w):
        return torch.randint(0, vocab, (s, w), generator=g, dtype=i32).to(dev)

    temps = torch.rand(s, generator=g).to(dev) + 0.5
    greedy = (torch.arange(s) % 2 == 0).to(dev)
    keys = torch.randint(-2**31, 2**31 - 1, (s, 2), generator=g,
                         dtype=i32).to(dev)
    if lane == "burst":
        return [toks(1), torch.tensor(5, dtype=i32, device=dev), keys[0]]
    if lane == "dr":
        return [toks(1), torch.full((s,), 5, dtype=i32, device=dev),
                torch.ones(s, dtype=torch.bool, device=dev), temps,
                torch.ones(s, dtype=torch.bool, device=dev), keys]
    if lane == "drp":
        w = coords[1]
        return [toks(w), torch.zeros(s, dtype=i32, device=dev),
                torch.full((s,), w, dtype=i32, device=dev), temps, greedy,
                keys]
    width = coords[1] if lane == "cbp" else eng.max_pages_per_req
    bt = (torch.arange(s * width, dtype=i32).view(s, width) % 30 + 1).to(dev)
    if lane == "cbp":
        pos = coords[1] * eng.ecfg.page_size - 3
        return [toks(1), torch.full((s,), pos, dtype=i32, device=dev), bt,
                torch.ones(s, dtype=torch.bool, device=dev), temps, greedy,
                keys]
    w = coords[1] if lane == "pf" else coords[1] + 1
    return [toks(w), torch.full((s,), 3, dtype=i32, device=dev), bt,
            torch.full((s,), w, dtype=i32, device=dev), temps, greedy, keys]


def _lane_cache(eng, key):
    lane, coords = key.lane, key.coords
    if lane == "burst":
        return eng.burst_cache(coords[0])
    if lane in ("dr", "drp"):
        return eng.draft_cache(coords[0], coords[2])
    return eng.paged_cache(coords[2])


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_cuda_graph_targets_equal_their_eager_steps(cuda, smoke, kv_dtype):
    """cbp, pf, vf, dr, drp and both burst modes: the captured target's
    outputs (tokens and split keys included) and cache writes equal the
    eager step's on the same inputs, caches and keys."""
    cfg, params = smoke
    ecfg = dict(ENGINE, spec_k=2, kv_dtype=kv_dtype, draft_kv_dtype=kv_dtype)
    engines = {
        g: serve.Engine(cfg, params, serve.EngineConfig(**ecfg,
                                                        cuda_graphs=g))
        for g in (True, False)
    }
    keys = [lanes.CBP.key(4, 2, kv_dtype, "1x1"),
            lanes.PF.key(4, 16, kv_dtype, "1x1"),
            lanes.VF.key(4, 2, kv_dtype, "1x1"),
            lanes.DR.key(4, 2, kv_dtype, "1x1"),
            lanes.DRP.key(4, 16, kv_dtype, "1x1"), lanes.BURST.key(4, 0),
            lanes.BURST.key(4, 1)]
    try:
        for i, key in enumerate(keys):
            outs = {}
            for graphs, eng in engines.items():
                exe = eng._decode.build(key)
                assert isinstance(exe, serve._GraphStep) == graphs
                cache = _lane_cache(eng, key)
                _fill(cache, seed=i)
                args = _lane_inputs(key, eng, seed=i)
                out = exe(cache, *args)
                leaves = [t.clone() for t in pytree.tree_leaves(out)
                          if isinstance(t, torch.Tensor)]
                torch.cuda.synchronize()
                outs[graphs] = leaves
            for a, b in zip(outs[True], outs[False], strict=True):
                if a.is_floating_point():
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
                else:
                    assert torch.equal(a, b), key
    finally:
        for eng in engines.values():
            eng.close()


def _cuda_stream(cfg, params, graphs, sample_frac):
    reqs = shared_prefix_arrivals(
        12, 300.0, seed=2, num_prefixes=3, prefix_len=20, tokens_mean=8,
        total_max=64, sample_frac=sample_frac, vocab=cfg.vocab_size,
    )
    with serve.Engine(cfg, params, serve.EngineConfig(
        **ENGINE, spec_k=2, cuda_graphs=graphs)) as eng:
        rep = serve.run_paged_stream(eng, reqs, slots=4, clock=_StepClock())
        graph_targets = all(isinstance(t, serve._GraphStep)
                            for t in eng._decode.cache._table.values())
    return {r.rid: r.tokens for r in reqs}, rep, graph_targets


@pytest.mark.cuda
def test_cuda_paged_stream_captures_nothing_after_warmup(cuda, smoke):
    cfg, params = smoke
    _, rep, graph_targets = _cuda_stream(cfg, params, True, 0.0)
    assert graph_targets and rep["cuda_graphs"]
    assert rep["finished"] == 12 and rep["compiles_after_warmup"] == 0
    assert rep["compiles_total"] > 0


@pytest.mark.cuda
def test_cuda_sampled_stream_equals_eager(cuda, smoke):
    """One seed, half the requests sampled: the graphs' tokens equal the
    eager targets' (the per-slot keys chain through each target's own
    inputs and are split by the same kernel in both)."""
    cfg, params = smoke
    toks, _, _ = _cuda_stream(cfg, params, True, 0.5)
    want, _, _ = _cuda_stream(cfg, params, False, 0.5)
    assert toks == want


@pytest.mark.cuda
def test_cuda_replays_count_their_kernel_launches(cuda, smoke):
    from repro_torch import kernels

    cfg, params = smoke
    with serve.Engine(cfg, params, serve.EngineConfig(**ENGINE)) as eng:
        key = lanes.CBP.key(4, 2, "fp32", "1x1")
        kernels.reset_launch_counts()
        exe = eng._decode.build(key)  # the capture's warmup run launches
        assert kernels.paged_decode_attention.launches == cfg.num_layers
        args = _lane_inputs(key, eng, seed=0)
        for n in (2, 3):
            exe(eng.paged_cache("fp32"), *args)
            assert kernels.paged_decode_attention.launches == (
                n * cfg.num_layers)
        assert exe.graph.replays == 2


@pytest.mark.cuda
def test_cuda_failed_capture_raises(cuda):
    def syncs(x):
        return x * float(x.sum().item())  # a host read: illegal in capture

    g = GraphTarget(syncs, [torch.ones(4, device=cuda)], name="sync-step")
    with pytest.raises(RuntimeError, match="capture failed"):
        g.capture()
    assert g.graph is None


@pytest.mark.cuda
def test_cuda_branch_changer_replays_graphs(cuda):
    fns = [lambda x: x + 1.0, lambda x: x * 2.0, lambda x: x - 3.0]
    bc = tcore.BranchChanger(*fns, name="gpu-switch")
    x = torch.arange(4.0, device=cuda)
    bc.compile(x)
    for d in (2, 0, 1, 1, 0):
        bc.set_direction(d, warm=True)
        assert torch.equal(bc.branch(x), fns[d](x))
    bc.set_direction(1)
    bc.static_inputs[0].fill_(5.0)  # inputs written in place: no copy
    assert torch.equal(bc(*bc.static_inputs), torch.full((4,), 10.0,
                                                         device=cuda))
    bad = tcore.BranchChanger(lambda v: v + 1, lambda v: v[:2] + 1,
                              name="gpu-bad")
    with pytest.raises(tcore.BranchChangerError, match="calling convention"):
        bad.compile(x)


@pytest.mark.cuda
def test_cuda_capture_survives_collectable_graphs(cuda):
    """A collection during a capture would destroy unreachable graphs (an
    engine's, held in a reference cycle), which invalidates the capture;
    capture holds the collector off."""
    import gc

    def garbage():
        g = GraphTarget(lambda x: x * 3, [torch.ones(4, device=cuda)],
                        name="old").capture()
        cycle = {"graph": g}
        cycle["self"] = cycle  # unreachable only through the collector
        return None

    threshold = gc.get_threshold()
    gc.collect()
    try:
        garbage()
        gc.set_threshold(1)  # collect at almost every allocation

        def step(x):
            junk = [[i] for i in range(64)]  # Python allocations mid-capture
            return x + len(junk)

        g = GraphTarget(step, [torch.ones(4, device=cuda)], name="new")
        g.capture()
        assert torch.equal(g(torch.zeros(4, device=cuda)),
                           torch.full((4,), 64.0, device=cuda))
    finally:
        gc.set_threshold(*threshold)
        gc.collect()
