"""Serving engine on the unified dispatch core (counterpart of
``repro.runtime.serve``: the per-burst engine and the dense and paged
continuous paths).

The HFT analogy (DESIGN.md §2/§4): the *hot path* is the token loop — it
never builds a step or branches on mode. The *cold path* is the scheduler: it
admits requests, picks the branch target in the ``Dispatcher``'s table,
warms it, and only then lets the hot loop run.

A **branch target** for a dispatch key is the step callable specialised on
the key's static shapes and page dtype — slots for the dense ``cb`` decode
lane, slots and ``chunk_bucket`` for its ``pfd`` prefill lane, slots and
``k_bucket`` for its ``vfd`` verify lane; slots, ``pages_bucket`` and
``kv_dtype`` for the ``cbp`` decode lane, slots, ``chunk_bucket`` and
``kv_dtype`` for the ``pf`` prefill lane, slots, ``k_bucket`` and
``kv_dtype`` for the ``vf`` verify lane, slots, ``k_bucket`` /
``chunk_bucket`` and ``draft_kv_dtype`` for the ``dr``/``drp`` draft lanes —
with the attention implementation (``EngineConfig.attn_impl``) and a MoE
stack's dispatch policy (``EngineConfig.moe_policy``) baked in when it is
built. On the card (``EngineConfig.cuda_graphs``, on by default
there) a target is a ``core.graph_target.GraphTarget``: the step captured
once as a CUDA graph over static input and output buffers and over the
engine's own state — one page pool per page dtype, one dense target cache
per slot count, one dense draft cache per (slots, draft dtype), one burst
cache per batch bucket — so taking the
branch is a copy of the few inputs that changed (none in steady-state
decode: the next token and position are written back into the graph's own
inputs) and one graph launch, where the eager step issues hundreds of
kernel launches from Python. On the CPU, or with ``cuda_graphs=False``, the
target is the eager step behind the same guard. **Build** is the capture;
**warm** means build plus one dummy run through the hot path. Every key in
every enabled lane's fan-out is warmed before the stream starts, so
``compiles_after_warmup`` (builds after the warm boundary) stays 0 and a
bucket, k or dtype crossing is a rebind.

The **per-burst engine** is the paper's construct in its plain form: a burst
of requests shares one sampling mode, ``set_mode`` (the cold path) buckets
the batch, dispatches the ``("burst", bucket, mode)`` target — building it
on first sight — rebinds the hot slot and warms it with a dummy run, and
``decode_loop`` (the hot path) calls the slot directly, step after step,
chaining tokens and the position on the device (kernel B5 reads the
position there) and pulling the tokens once at the end.
``run_burst_stream`` drives a request stream through it, each burst on the
bucket's cache zeroed; its builds after the stream starts are the keys it
first meets, the baseline cost the continuous engines remove. It serves the SSM family too: a mamba slot's
dense cache is its recurrent conv window and state, stepped in place. The
paged path is attention-only.

The **dense continuous engine** (``continuous``, ``run_continuous_stream``)
seats requests in the slots of one dense cache, each slot at its own
position: ``cb`` decodes one token per slot, ``pfd`` ingests prompt chunks,
and with speculation ``dr``/``vfd``/``drp`` draft and verify. Its per-row
attention runs B1-B4 over the cache's identity page view
(``models.dense_page_view``). An SSM stack serves ``cb`` only, prompts
forced token by token, as in the JAX package.

Every branch target runs under the ``perf`` opts current when it was
built (``repro_torch.perf.bake``), whatever the ambient opts at its call.

The **overload-hardened paged stream** (``run_overload_stream``, DESIGN.md
§15) is the paper's construct applied to load: bounded admission with shed
policies and queue TTLs, deadlines and cancellation, a degradation ladder
whose rungs move the batchers' knobs over warmed keys and route new
admissions to a pre-warmed int8 standby pool, fault injection at five
sites, a step-count heartbeat and the step-time watchdog. The cold-path
controller flips which warmed target the hot path runs; the hot path never
tests "are we overloaded?".

The engine runs on the card by default (``device="cuda"``) and raises when
no GPU is present unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import models, perf, prng
from repro_torch.configs import ArchConfig
from repro_torch.kernels import build as kernel_build
from repro_torch.core import DispatchError, DispatchPolicy, Dispatcher
from repro_torch.core import bucket_multiple
from repro_torch.core.graph_target import GraphTarget, check_args
from repro_torch.core import lanes as lanes_mod
from repro_torch.core.lanes import LANES
from repro_torch.core.telemetry import Telemetry
from repro_torch.ft.failover import HeartbeatMonitor, StepTimeWatchdog
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.admission import AdmissionQueue
from repro_torch.runtime.degrade import (
    DegradeController,
    Rung,
    apply_rung,
    default_ladder,
)
from repro_torch.models.layers import dtype_of
from repro_torch.runtime.kvcache import (
    KV_DTYPES,
    PagePool,
    PrefixCache,
    sharing_report,
)
from repro_torch.runtime.scheduler import (
    CHUNK_BUCKET_MIN,
    Clock,
    ContinuousBatcher,
    PagedContinuousBatcher,
    Request,
    RequestQueue,
    form_bursts,
    latency_report,
)

GREEDY, SAMPLE = 0, 1


@dataclass
class EngineConfig:
    max_len: int = 512
    # Per-burst engine: batch sizes round up to a multiple of batch_quantum
    # (each a ("burst", bucket, mode) key); sampled bursts draw at
    # temperature.
    batch_quantum: int = 4
    max_batch: int = 64
    temperature: float = 1.0
    # Dispatch policy (DESIGN.md §3): how sticky is the hot slot, and how
    # many branch targets may the table keep (None = all).
    hysteresis: int = 1
    cache_capacity: int | None = None
    # Paged KV cache (DESIGN.md §9): page granularity and pool size
    # (allocatable pages, excluding the reserved null page). 0 pages means
    # "dense-equivalent": max_batch × max_len tokens worth of pages.
    page_size: int = 16
    num_pages: int = 0
    # Chunked prefill (DESIGN.md §10): the largest prompt chunk ingested per
    # step; 0 disables the chunked lane (prompts teacher-force token by
    # token). Chunk sizes come from the log-sized bucket set {8, ...,
    # prefill_chunk}, each a warmed ("pf", slots, chunk_bucket, kv_dtype)
    # key.
    prefill_chunk: int = 0
    # Attention implementation baked into every step (semi-static):
    # "kernel" (B1-B4; their plain versions on the CPU) or "plain".
    attn_impl: str = "kernel"
    # MoE dispatch policy baked into every step of a MoE stack (semi-static,
    # models.moe): "drop" (capacity-bounded), "dense" or "gather"; each
    # policy is its own built and captured target, so switching is cold-path
    # work (a new engine).
    moe_policy: str = "drop"
    # Speculative decoding (DESIGN.md §11): max draft depth per target step
    # (0 disables the draft/verify lanes; per-step k comes from the
    # log-sized k-bucket set {1, 2, ..., spec_k}, each a warmed key) and the
    # truncated-layer draft view's depth in layer periods.
    spec_k: int = 0
    draft_layers: int = 1
    # Page storage dtype (DESIGN.md §12): "fp32" keeps pages in the model
    # dtype, "int8" stores int8 pages plus per-row scales (kernels B3/B4);
    # kv_dtypes lists extra dtypes to warm, so a pool on one of them is a
    # rebind, never a build.
    kv_dtype: str = "fp32"
    kv_dtypes: tuple = ()
    # The draft's dense-cache dtype and extras to warm (DESIGN.md §16): an
    # int8 draft pairs with a model-dtype verify pool.
    draft_kv_dtype: str = "fp32"
    draft_kv_dtypes: tuple = ()
    # Branch targets as CUDA graphs (module docstring): None = on where the
    # engine's device is cuda; False keeps the eager steps on the card (the
    # comparison runs); True on a CPU engine raises.
    cuda_graphs: bool | None = None


@dataclass
class _WarmCtx:
    """State threaded through one warmup pass: the batcher's speculation
    opt-in. The dummy runs feed zero keys, so warmup draws nothing from the
    stream's seed, and write into the engine's own caches: the pools' null
    page only, the dense caches' rows at position 0 (and a mamba slot's
    state)."""

    spec: bool = False


class _Owner:
    """A batcher's claim on the engine storage its targets run over: held
    by the batcher (``storage``) and its draft dispatch closures, so it
    lives as long as the batcher. ``bank`` is its page pool's or dense
    cache's, claimed at the top of each of its steps (the draft cache's is
    claimed where a draft lane is dispatched). ``mirror`` is the batcher's
    device mirror (``scheduler._DeviceMirror``, set by the batcher),
    detached whenever another batcher's calls, or a new batcher's warmup,
    are about to replay targets whose static inputs it may hold."""

    __slots__ = ("bank", "mirror", "__weakref__")

    def __init__(self) -> None:
        self.bank: _StorageBank | None = None
        self.mirror = None

    def detach(self) -> None:
        if self.mirror is not None:
            self.mirror.detach()

    def claim(self) -> None:
        """Put this batcher's state back into its pool or dense cache."""
        self.bank.claim(self)


class _StorageBank:
    """Whose state one of the engine's cache tensor sets holds. A lane's
    targets are keyed by shapes and dtypes, not by batcher, and are bound
    (captured, on the card) to the engine's one page pool per dtype, one
    dense cache per slot count and one draft cache per slot count and draft
    dtype; so every batcher of one key runs over the same tensors. Each
    batcher keeps its own state all the same, as each JAX batcher owns its
    cache value: ``claim`` parks the resident owner's state in a copy of its
    own and restores the caller's, always with ``copy_`` into the captured
    tensors, never rebinding them (the graphs hold their addresses).

    The cost: with one batcher on a tensor set nothing is copied. When two
    batchers of one key alternate, each switch copies the whole set twice
    (park the resident, restore the caller): a bf16 olmo-1b pool of 8 x
    1024 tokens is 1.07 GB, so a switch moves 4.3 GB, ~1.3 ms at the card's
    memory rate. The parked copy holds the set's bytes once per batcher
    that has been displaced, on top of the set itself, at the peak."""

    def __init__(self, cache: list) -> None:
        self.cache = cache
        self._owner: weakref.ref | None = None
        self._parked: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    def _resident(self) -> _Owner | None:
        return self._owner() if self._owner is not None else None

    def vacate(self) -> None:
        """Park the resident owner's state and detach its mirror: the
        engine is about to zero the set for a new batcher and warm its lanes
        over it, or another batcher is about to step over it."""
        owner = self._resident()
        if owner is not None:
            saved = self._parked.get(owner)
            if saved is None:
                self._parked[owner] = [
                    {n: t.clone() for n, t in layer.items()}
                    for layer in self.cache
                ]
            else:
                _copy_cache(saved, self.cache)
            owner.detach()
        self._owner = None

    def seat(self, owner: _Owner) -> None:
        """``owner``'s state is the one the set holds now."""
        self._owner = weakref.ref(owner)

    def claim(self, owner: _Owner) -> None:
        """Make ``owner``'s state the resident one (a copy only when
        another batcher of the key stepped last)."""
        if self._resident() is owner:
            return
        self.vacate()
        _copy_cache(self.cache, self._parked[owner])
        self.seat(owner)


def _copy_cache(dst: list, src: list) -> None:
    for d, s in zip(dst, src):
        for name, t in d.items():
            t.copy_(s[name])


class _GraphStep:
    """A lane's branch target on the card: a ``GraphTarget`` over the
    engine's own cache, called as the eager target is, ``target(cache,
    *rows)``."""

    __slots__ = ("graph",)

    def __init__(self, graph: GraphTarget):
        self.graph = graph

    @property
    def static_inputs(self) -> tuple:
        """The rows' static inputs, in call order (an upload may land in
        one directly)."""
        return self.graph.static_inputs

    def __call__(self, cache, *args):
        if cache is not self.graph.owned:
            raise ValueError(
                f"cache: {self.graph.name} was captured over the engine's own "
                f"cache and runs on no other"
            )
        return self.graph(*args)


class Engine:
    """Single-device engine: the per-burst engine and the dense and paged
    serving lanes."""

    def __init__(
        self,
        cfg: ArchConfig,
        params: dict,
        ecfg: EngineConfig,
        telemetry: Telemetry | None = None,
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Engine runs on the GPU by default and no CUDA device is "
                    "available; pass device='cpu' to run on the CPU."
                )
            if self.device.index is None:  # pin "cuda" to a concrete card
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.graphs = (
            self.device.type == "cuda" if ecfg.cuda_graphs is None
            else bool(ecfg.cuda_graphs)
        )
        if self.graphs and self.device.type != "cuda":
            raise ValueError(
                f"cuda_graphs=True needs a CUDA device, the engine is on "
                f"{self.device}"
            )
        if ecfg.attn_impl not in models.ATTN_IMPLS:
            raise ValueError(
                f"attn_impl must be one of {models.ATTN_IMPLS}, got "
                f"{ecfg.attn_impl!r}"
            )
        if ecfg.moe_policy not in models.MOE_POLICIES:
            raise ValueError(
                f"moe_policy must be one of {models.MOE_POLICIES}, got "
                f"{ecfg.moe_policy!r}"
            )
        self.cfg = cfg
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.ecfg = ecfg
        # Speculative decoding: the draft is a truncated-layer view of the
        # target (shared embedding/head, the first draft_layers periods of
        # blocks), so it costs no extra weights.
        self.draft_cfg = self.draft_params = None
        if ecfg.spec_k > 0:
            self.draft_cfg, self.draft_params = models.draft_view(
                cfg, self.params, ecfg.draft_layers
            )
        self.telemetry = telemetry or Telemetry()
        self._warm_marks: dict | None = None
        self._burst_calls = None  # lazy: lane_calls_total{lane="burst"}
        self._burst_hist = None  # lazy: lane_step_ms{lane="burst"}
        self._decode = Dispatcher(
            self._build,
            name=f"decode@{id(self):x}",
            policy=DispatchPolicy(
                hysteresis=ecfg.hysteresis, capacity=ecfg.cache_capacity
            ),
            recorder=self.telemetry.recorder,
        )
        self._current: Callable | None = None  # mirror of the hot slot
        self.stats = {"tokens": 0, "hot_calls": 0, "mode_switches": 0}
        # the engine's own state, which graph targets are captured over
        self._paged_caches: dict = {}  # kv_dtype -> page pool
        self._dense_caches: dict = {}  # slots -> dense target cache
        self._draft_caches: dict = {}  # (slots, draft dtype) -> dense cache
        # whose state each of those tensor sets holds (C13):
        # ("paged", dtype) / ("dense", slots) / ("draft", slots, dtype)
        self._banks: dict = {}
        self._owners: weakref.WeakSet = weakref.WeakSet()  # live batchers
        self._burst_caches: dict = {}  # batch bucket -> dense cache
        # one memory pool for every graph (they never run concurrently)
        self._graph_pool = (
            torch.cuda.graph_pool_handle() if self.graphs else None
        )

    def close(self) -> None:
        """Release the dispatcher's entry-point name."""
        self._decode.close()

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # ------------------------------------------------------------ cold path
    def _build(self, key: tuple) -> Callable:
        """Dispatcher builder: the key's lane resolves to its ``LaneSpec``,
        whose ``builder`` hook returns the branch target. An unregistered
        lane or malformed key raises ``UnknownLaneError`` here."""
        spec = LANES.spec_for(key)
        return getattr(self, spec.builder)(*spec.coords(key))

    def _target(
        self, key: tuple, step: Callable, rows: dict, cache: list,
        cache_dtype: torch.dtype, *, params: dict | None = None,
        chain: dict | None = None,
    ) -> Callable:
        """A key's branch target: ``step`` bound to its weights (``params``,
        default the target's), to ``rows`` (name -> (shape, dtype) of each
        input after the cache) and to the cache dtype, called as
        ``target(cache, *rows)``. A call with another shape, dtype or
        device, or another cache dtype, is a dispatch bug and raises (the
        aval guard of a compiled executable). With graphs it is captured
        over ``cache`` (the engine's own), with ``chain`` mapping outputs to
        the inputs they feed (the next token, positions and keys).

        The target runs under the ``perf`` opts current when it is built,
        on every call (semi-static, as a traced step): with
        ``attn_impl="kernel"`` a sub-f32 ``score_dtype``/``probs_dtype``
        raises here, at build."""
        if self.ecfg.attn_impl == "kernel" and self.cfg.has_attention:
            perf.check_kernel_opts(f"{key}: attn_impl='kernel'")
        step = perf.bake(step)
        params = self.params if params is None else params
        specs = [(n, tuple(shape), dt) for n, (shape, dt) in rows.items()]
        if not self.graphs:
            return self._guarded(step, specs, cache_dtype, params)
        examples = [
            torch.ones(shape, dtype=dt, device=self.device)
            if dt.is_floating_point
            else torch.zeros(shape, dtype=dt, device=self.device)
            for _, shape, dt in specs
        ]
        names = [n for n, _, _ in specs]
        graph = GraphTarget(
            lambda *ins: step(params, cache, *ins), examples, owned=cache,
            pool=self._graph_pool, chain=chain, names=names, name=str(key),
        ).capture()
        return _GraphStep(graph)

    def _guarded(
        self, step: Callable, specs: list, cache_dtype: torch.dtype,
        params: dict,
    ) -> Callable:
        """The eager target (CPU, or ``cuda_graphs=False``)."""
        device = self.device

        def target(cache, *args):
            # the K/V rows or pages, or a mamba slot's conv window
            got = cache[0]["k" if "k" in cache[0] else "conv"].dtype
            if got != cache_dtype:
                raise ValueError(
                    f"cache: expected {cache_dtype} K/V, got {got}"
                )
            check_args(specs, args, device)
            return step(params, cache, *args)

        return target

    def _kv_torch_dtype(self, kv_dtype: str, cfg: ArchConfig) -> torch.dtype:
        """The K/V tensors' dtype for a ``kv_dtype`` coordinate."""
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}"
            )
        return torch.int8 if kv_dtype == "int8" else dtype_of(cfg)

    def _build_burst_decode(self, batch: int, mode: int) -> Callable:
        """Branch target for ``("burst", batch_bucket, mode)``: a dense-cache
        decode step over the whole bucket at one position, with the sampling
        mode baked in (the per-burst engine, DESIGN.md §2), over the
        bucket's own cache. Its next token and position feed its next
        call; ``key [2]`` is the step's own (``decode_loop``)."""
        step = steps_mod.make_sampling_decode_fn(
            self.cfg, mode=mode, temperature=self.ecfg.temperature,
            attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
        )
        i32 = torch.int32
        tokens = self.cfg.input_kind == "tokens"
        return self._target(
            lanes_mod.BURST.key(batch, mode), step,
            {"tok": self._burst_input(batch), "pos": ((), i32),
             "key": ((2,), i32)},
            self.burst_cache(batch), dtype_of(self.cfg),
            chain={2: 0, 3: 1} if tokens else {3: 1},
        )

    def _burst_input(self, batch: int) -> tuple:
        """(shape, dtype) of a burst step's input: i32 token ids
        ``[B,1]``, or stub-frontend embeddings ``[B,1,D]`` in the model
        dtype for an embeddings arch."""
        if self.cfg.input_kind == "tokens":
            return (batch, 1), torch.int32
        return (batch, 1, self.cfg.d_model), dtype_of(self.cfg)

    def _build_slot_decode(self, slots: int) -> Callable:
        """Branch target for ``("cb", slots)``: the dense continuous decode
        step over the engine's dense cache of ``slots`` rows, every slot at
        its own position, sampling params as data (DESIGN.md §4). The next
        token, positions and keys feed its next call."""
        step = steps_mod.make_slot_decode_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
        )
        i32 = torch.int32
        return self._target(
            lanes_mod.CB.key(slots), step, {
                "tok": ((slots, 1), i32), "pos": ((slots,), i32),
                "active": ((slots,), torch.bool),
                **self._sampling_rows(slots),
            }, self.dense_cache(slots), dtype_of(self.cfg),
            chain={4: 0, 2: 1, 3: 5},
        )

    def _build_slot_prefill(self, slots: int, chunk_bucket: int) -> Callable:
        """Branch target for ``("pfd", slots, chunk_bucket)``: batched
        chunked prefill into the dense cache (DESIGN.md §10) — a slot's rows
        are a trivial identity block table, so the chunk-bucket machinery of
        the paged lane serves both engines."""
        step = steps_mod.make_slot_prefill_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
        )
        return self._target(
            lanes_mod.PFD.key(slots, chunk_bucket), step,
            self._dense_chunk_rows(slots, chunk_bucket),
            self.dense_cache(slots), dtype_of(self.cfg), chain={2: 5},
        )

    def _build_slot_verify(self, slots: int, k: int) -> Callable:
        """Branch target for ``("vfd", slots, k)``: the dense verify pass
        (DESIGN.md §11), K+1 window rows through the dense chunk path."""
        step = steps_mod.make_slot_verify_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
        )
        return self._target(
            lanes_mod.VFD.key(slots, k), step,
            self._dense_chunk_rows(slots, k + 1), self.dense_cache(slots),
            dtype_of(self.cfg), chain={3: 5},
        )

    def _build_paged_slot_decode(
        self, slots: int, pages_bucket: int, kv_dtype: str
    ) -> Callable:
        """Branch target for ``("cbp", slots, pages_bucket, kv_dtype)``:
        capacity is a semi-static condition (DESIGN.md §9) — the block
        table's width is part of the target's shapes, and outgrowing the
        bucket re-dispatches on the cold path; the page dtype is another
        (DESIGN.md §12), so model-dtype and int8 pools are two targets. The
        next token, positions and keys feed its next call."""
        step = steps_mod.make_paged_slot_decode_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
        )
        i32 = torch.int32
        return self._target(
            lanes_mod.CBP.key(slots, pages_bucket, kv_dtype), step, {
                "tok": ((slots, 1), i32), "pos": ((slots,), i32),
                "block_tables": ((slots, pages_bucket), i32),
                "active": ((slots,), torch.bool),
                **self._sampling_rows(slots),
            }, self.paged_cache(kv_dtype),
            self._kv_torch_dtype(kv_dtype, self.cfg),
            chain={4: 0, 2: 1, 3: 6},
        )

    @staticmethod
    def _sampling_rows(slots: int) -> dict:
        return {"temps": ((slots,), torch.float32),
                "greedy": ((slots,), torch.bool),
                "keys": ((slots, 2), torch.int32)}

    def _dense_chunk_rows(self, slots: int, width: int) -> dict:
        """The dense chunk lanes' inputs (``pfd``, ``vfd``, ``drp``)."""
        i32 = torch.int32
        return {
            "tok": ((slots, width), i32), "start": ((slots,), i32),
            "length": ((slots,), i32), **self._sampling_rows(slots),
        }

    def _chunk_rows(self, slots: int, width: int) -> dict:
        """The paged chunk lanes' inputs: the block table is pinned at the
        per-request page cap."""
        i32 = torch.int32
        return {
            "tok": ((slots, width), i32), "start": ((slots,), i32),
            "block_tables": ((slots, self.max_pages_per_req), i32),
            "length": ((slots,), i32), **self._sampling_rows(slots),
        }

    def _build_paged_prefill(
        self, slots: int, chunk_bucket: int, kv_dtype: str
    ) -> Callable:
        """Branch target for ``("pf", slots, chunk_bucket, kv_dtype)``:
        batched chunked prefill (DESIGN.md §10). The chunk width is part of
        the shapes; the block table is pinned at the per-request page cap."""
        step = steps_mod.make_paged_prefill_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
        )
        return self._target(
            lanes_mod.PF.key(slots, chunk_bucket, kv_dtype), step,
            self._chunk_rows(slots, chunk_bucket), self.paged_cache(kv_dtype),
            self._kv_torch_dtype(kv_dtype, self.cfg), chain={2: 6},
        )

    def _build_paged_verify(self, slots: int, k: int, kv_dtype: str) -> Callable:
        """Branch target for ``("vf", slots, k, kv_dtype)``: the target
        scores all K+1 window positions in one pass through the paged chunk
        path (DESIGN.md §11). The window width k+1 is part of the shapes;
        the block table is pinned at the per-request page cap."""
        step = steps_mod.make_paged_verify_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
        )
        return self._target(
            lanes_mod.VF.key(slots, k, kv_dtype), step,
            self._chunk_rows(slots, k + 1), self.paged_cache(kv_dtype),
            self._kv_torch_dtype(kv_dtype, self.cfg), chain={3: 6},
        )

    def _build_draft(self, slots: int, k: int, draft_kv_dtype: str) -> Callable:
        """Branch target for ``("dr", slots, k, draft_kv_dtype)``: K draft
        decode steps looped inside one target (DESIGN.md §11), so depth
        variation re-dispatches on the cold path; the draft cache's dtype is
        its own coordinate (DESIGN.md §16). Its keys are the batcher's,
        split and discarded (``steps.make_draft_fn``)."""
        step = steps_mod.make_draft_fn(
            self.draft_cfg, k=k, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
        )
        i32 = torch.int32
        return self._target(
            lanes_mod.DR.key(slots, k, draft_kv_dtype), step, {
                "tok": ((slots, 1), i32), "pos": ((slots,), i32),
                "active": ((slots,), torch.bool),
                **self._sampling_rows(slots),
            }, self.draft_cache(slots, draft_kv_dtype),
            self._kv_torch_dtype(draft_kv_dtype, self.draft_cfg),
            params=self.draft_params,
        )

    def _build_draft_prefill(
        self, slots: int, chunk_bucket: int, draft_kv_dtype: str
    ) -> Callable:
        """Branch target for ``("drp", slots, chunk_bucket,
        draft_kv_dtype)``: the draft's prompt mirror — chunked dense
        ingestion over the draft view, so its cache tracks the prompts."""
        step = steps_mod.make_slot_prefill_fn(
            self.draft_cfg, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
        )
        return self._target(
            lanes_mod.DRP.key(slots, chunk_bucket, draft_kv_dtype), step,
            self._dense_chunk_rows(slots, chunk_bucket),
            self.draft_cache(slots, draft_kv_dtype),
            self._kv_torch_dtype(draft_kv_dtype, self.draft_cfg),
            params=self.draft_params,
        )

    # ------------------------------------------------------ engine state
    def paged_cache(self, kv_dtype: str) -> list:
        """The page pool of ``kv_dtype`` (null page included), created on
        first use: every paged target of that dtype is bound to it."""
        if kv_dtype not in self._paged_caches:
            self._paged_caches[kv_dtype] = models.init_paged_cache(
                self.cfg, self.pool_physical_pages, self.ecfg.page_size,
                kv_dtype, device=self.device,
            )
        return self._paged_caches[kv_dtype]

    def dense_cache(self, slots: int) -> list:
        """The dense continuous engine's cache of ``slots`` rows of
        ``models.dense_rows(max_len)`` positions (model dtype; ``max_len``
        rounded up to a multiple of 8, so its page view exists), created on
        first use: every ``cb``, ``pfd`` and ``vfd`` target of that slot
        count is bound to it, and ``continuous`` hands it to its batcher,
        which still admits requests by ``max_len``."""
        if slots not in self._dense_caches:
            self._dense_caches[slots] = models.init_cache(
                self.cfg, slots, models.dense_rows(self.ecfg.max_len),
                device=self.device,
            )
        return self._dense_caches[slots]

    def draft_cache(self, slots: int, draft_kv_dtype: str) -> list:
        """The draft view's dense cache for ``slots`` rows of
        ``models.dense_rows(max_len)`` positions, created on first use."""
        key = (slots, draft_kv_dtype)
        if key not in self._draft_caches:
            self._draft_caches[key] = models.init_cache(
                self.draft_cfg, slots, models.dense_rows(self.ecfg.max_len),
                draft_kv_dtype, device=self.device,
            )
        return self._draft_caches[key]

    def _new_owner(self) -> _Owner:
        """A new batcher's claim. Its warmup replays targets that other
        live batchers may hold static inputs of (every warmed dtype's, the
        draft lanes'), so their mirrors are detached first."""
        for other in list(self._owners):
            other.detach()
        owner = _Owner()
        self._owners.add(owner)
        return owner

    def _reset_storage(self, key: tuple, cache: list) -> _StorageBank:
        """Park the state of the batcher resident in ``cache`` and zero it
        (a fresh engine's) for a new batcher; the rest stay as they are."""
        bank = self._banks.setdefault(key, _StorageBank(cache))
        bank.vacate()
        self.zero_cache(cache)
        return bank

    def _reset_drafts(self, slots: int, draft_kv_dtype: str,
                      owner: _Owner) -> None:
        """A new speculating batcher on ``slots``: park every warmed draft
        dtype's resident state and zero those caches (its warmup writes
        them all); ``owner``'s state is the ``draft_kv_dtype`` cache's
        after the batcher's warmup."""
        for d in self._warm_draft_kv_dtypes():
            bank = self._reset_storage(("draft", slots, d),
                                       self.draft_cache(slots, d))
            if d == draft_kv_dtype:
                bank.seat(owner)

    def burst_cache(self, bucket: int) -> list:
        """The dense cache of a batch bucket (``max_len`` rows), shared by
        both modes' burst targets and created on first use. ``set_mode``
        warms on it, so fill it (or zero it) after ``set_mode``."""
        if bucket not in self._burst_caches:
            self._burst_caches[bucket] = models.init_cache(
                self.cfg, bucket, self.ecfg.max_len, device=self.device
            )
        return self._burst_caches[bucket]

    @staticmethod
    def zero_cache(cache: list) -> list:
        """Zero a cache in place (cold path): a fresh cache's state."""
        for slot_cache in cache:
            for t in slot_cache.values():
                t.zero_()
        return cache

    @property
    def pool_pages(self) -> int:
        """Allocatable page count (excluding the null page)."""
        if self.ecfg.num_pages > 0:
            return self.ecfg.num_pages
        return (self.ecfg.max_batch * self.ecfg.max_len) // self.ecfg.page_size

    @property
    def max_pages_per_req(self) -> int:
        """Per-request page cap: a full max_len sequence, pool permitting."""
        return min(
            self.pool_pages, -(-self.ecfg.max_len // self.ecfg.page_size)
        )

    @property
    def pool_physical_pages(self) -> int:
        """Device page-axis extent: allocatable pages plus the null page."""
        return self.pool_pages + 1

    # ----------------------------------------------- registry axis ladders
    def _chunk_buckets(self) -> list[int]:
        """The log-sized chunk-bucket fan-out {8, 16, ..., prefill_chunk}."""
        if self.ecfg.prefill_chunk <= 0:
            return []
        out, b = [], CHUNK_BUCKET_MIN
        while True:
            b = min(b, self.ecfg.prefill_chunk)
            out.append(b)
            if b >= self.ecfg.prefill_chunk:
                return out
            b *= 2

    def _k_buckets(self) -> list[int]:
        """The log-sized k-bucket fan-out {1, 2, 4, ..., spec_k}."""
        if self.ecfg.spec_k <= 0:
            return []
        out, b = [], 1
        while True:
            b = min(b, self.ecfg.spec_k)
            out.append(b)
            if b >= self.ecfg.spec_k:
                return out
            b *= 2

    def _pages_buckets(self) -> list[int]:
        """The log-sized capacity-bucket fan-out {1, 2, ..., page cap}."""
        out, pb = [], 1
        while True:
            out.append(pb)
            if pb >= self.max_pages_per_req:
                return out
            pb = min(pb * 2, self.max_pages_per_req)

    def _warm_kv_dtypes(self) -> tuple[str, ...]:
        """The kv_dtype axis ladder: the configured pool dtype plus the
        extras to keep warm, deduped."""
        return tuple(
            dict.fromkeys((self.ecfg.kv_dtype,) + tuple(self.ecfg.kv_dtypes))
        )

    def _warm_draft_kv_dtypes(self) -> tuple[str, ...]:
        """The draft lanes' storage-dtype ladder, deduped."""
        return tuple(
            dict.fromkeys(
                (self.ecfg.draft_kv_dtype,) + tuple(self.ecfg.draft_kv_dtypes)
            )
        )

    def _attention_only(self) -> bool:
        return all(self.cfg.mixer_at(slot).startswith("attn")
                   for slot in range(self.cfg.period))

    def _supports_chunked_prefill(self, ctx: Any = None) -> bool:
        """The ``pf``/``pfd`` lanes' gate (``LaneSpec.enabled``): a chunk
        size set, and an attention-only stack (an SSM slot's recurrent
        state would need a per-chunk scan)."""
        return self.ecfg.prefill_chunk > 0 and self._attention_only()

    def _supports_spec_decode(self) -> bool:
        """Speculation needs a draft depth and, since the verify lane rides
        the chunk path, an attention-only stack."""
        return self.ecfg.spec_k > 0 and self._attention_only()

    def _check_kernels(self) -> None:
        """With ``attn_impl="kernel"`` per-row attention runs B1-B4 (over
        pages, or over a dense cache's page view): on the card, raise
        ``ValueError`` at build, naming the shape, where no kernel is
        instantiated for the model's dtype and head_dim. Never a quiet plain
        path."""
        cfg = self.cfg
        if (self.ecfg.attn_impl == "kernel" and cfg.has_attention
                and self.device.type == "cuda"):
            kernel_build.check_head_dim(cfg.name, dtype_of(cfg), cfg.head_dim)

    def _spec_lanes_enabled(self, ctx: "_WarmCtx") -> bool:
        """The draft/verify lanes' gate: the batcher's opt-in and support."""
        return bool(ctx.spec) and self._supports_spec_decode()

    # ----------------------------------------------------- registry warmup
    # One warm method per LaneSpec: dummy-run the freshly built target
    # through the runtime path (upload, call, packed pull) with inactive
    # slots, null tables and length 0, so no live page is written.
    def _zeros(self, *shape: int, dtype=torch.int32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _warm_sampling(self, s: int) -> tuple:
        return (
            torch.ones(s, dtype=torch.float32, device=self.device),
            torch.ones(s, dtype=torch.bool, device=self.device),
            self._zeros(s, 2),
        )

    def _warm_cb(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s = key
        out = exe(
            self.dense_cache(s), self._zeros(s, 1), self._zeros(s),
            self._zeros(s, dtype=torch.bool), *self._warm_sampling(s),
        )
        steps_mod.pull_host(out[5])

    def _warm_pfd(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, cb = key
        out = exe(
            self.dense_cache(s), self._zeros(s, cb), self._zeros(s),
            self._zeros(s), *self._warm_sampling(s),
        )
        steps_mod.pull_host(out[3])

    def _warm_vfd(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, k = key
        out = exe(
            self.dense_cache(s), self._zeros(s, k + 1), self._zeros(s),
            self._zeros(s), *self._warm_sampling(s),
        )
        steps_mod.pull_host(out[4])

    def _warm_cbp(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, pb, dt = key
        out = exe(
            self.paged_cache(dt), self._zeros(s, 1), self._zeros(s),
            self._zeros(s, pb), self._zeros(s, dtype=torch.bool),
            *self._warm_sampling(s),
        )
        steps_mod.pull_host(out[5])

    def _warm_pf(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, cb, dt = key
        out = exe(
            self.paged_cache(dt), self._zeros(s, cb), self._zeros(s),
            self._zeros(s, self.max_pages_per_req), self._zeros(s),
            *self._warm_sampling(s),
        )
        steps_mod.pull_host(out[3])

    def _warm_vf(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, k, dt = key
        out = exe(
            self.paged_cache(dt), self._zeros(s, k + 1), self._zeros(s),
            self._zeros(s, self.max_pages_per_req), self._zeros(s),
            *self._warm_sampling(s),
        )
        steps_mod.pull_host(out[4])

    def _warm_dr(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, k, dt = key
        drafts, _, _, _ = exe(
            self.draft_cache(s, dt), self._zeros(s, 1),
            self._zeros(s), self._zeros(s, dtype=torch.bool),
            *self._warm_sampling(s),
        )
        steps_mod.pull_host(drafts)

    def _warm_drp(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, cb, dt = key
        out = exe(
            self.draft_cache(s, dt), self._zeros(s, cb),
            self._zeros(s), self._zeros(s), *self._warm_sampling(s),
        )
        steps_mod.pull_host(out[3])

    def _warm_lanes(self, kind: str, slots: int, ctx: _WarmCtx) -> None:
        """Registry-driven warmup (DESIGN.md §12): every enabled lane spec,
        every key in its fan-out, built and dummy-run."""
        for spec in LANES.for_engine(kind):
            if spec.enabled is not None and not getattr(self, spec.enabled)(ctx):
                continue
            for key in spec.fanout(self, slots=slots):
                exe = self._decode.build(key)
                getattr(self, spec.warmer)(key, exe, ctx)

    def mark_warm_boundary(self) -> None:
        """Snapshot the dispatcher's build (on the card: capture) and
        rebind counters and roll the
        metrics registry into its ``"warmup"`` section, so post-warmup
        gates read clean numbers by construction (DESIGN.md §14)."""
        st = self._decode.stats
        self._warm_marks = {"compiles": st.misses, "rebinds": st.rebinds}
        self.telemetry.registry.rollover("warmup")
        rec = self.telemetry.trace_or_none()
        if rec is not None:
            rec.emit("warm_boundary", "dispatcher",
                     args={"compiles": st.misses, "rebinds": st.rebinds})

    @property
    def post_warmup_compiles(self) -> int:
        """Dispatcher builds (captures) since the last
        ``mark_warm_boundary``."""
        base = (self._warm_marks or {}).get("compiles", 0)
        return self._decode.stats.misses - base

    @property
    def post_warmup_rebinds(self) -> int:
        base = (self._warm_marks or {}).get("rebinds", 0)
        return self._decode.stats.rebinds - base

    def attach_faults(self, plan) -> None:
        """Arm a ``core.faults.FaultPlan`` at the engine's ``build`` site
        (the dispatcher's cold path; on the card a build is a capture).
        Batcher- and pool-side sites are armed on those objects directly."""
        self._decode.attach_faults(plan)

    # ------------------------------------------------------ per-burst engine
    def set_mode(self, *, batch: int, sampling: int = GREEDY) -> dict:
        """Cold path: bucket the batch, build-or-fetch the burst target,
        rebind the hot slot, and warm it with one dummy run on the bucket's
        cache (dummy-order warming, paper §4.3), which writes position 0:
        fill or zero ``burst_cache(bucket)`` after this call."""
        t0 = time.perf_counter()
        bucket = bucket_multiple(
            batch, self.ecfg.batch_quantum, self.ecfg.max_batch
        )
        key = lanes_mod.BURST.key(bucket, sampling)
        exe = self._decode.dispatch(key)
        self._current = exe  # <- the jmp patch (engine-side mirror)
        shape, dt = self._burst_input(bucket)
        out = exe(self.burst_cache(bucket), self._zeros(*shape, dtype=dt),
                  self._zeros(), self._zeros(2))
        steps_mod.pull_host(out[0])
        self.stats["mode_switches"] += 1
        self.telemetry.registry.inc("mode_switches_total")
        return {
            "bucket": bucket,
            "key": key,
            "switch_s": time.perf_counter() - t0,
            "compiles": self._decode.stats.misses,
        }

    def decode_loop(
        self,
        cache: list,
        first_token: torch.Tensor,
        start_pos: int,
        num_tokens: int,
        rng: torch.Tensor | None = None,
        on_step: Callable[[int, torch.Tensor], None] | None = None,
    ) -> tuple[np.ndarray, list]:
        """The latency-critical loop: direct calls of the hot slot only.

        ``first_token`` i32[B,1] (B = the bucket ``set_mode`` chose), or
        for an embeddings arch ``[B,D]`` or ``[B,1,D]`` embeddings, cast to
        the model dtype, with ``num_tokens`` at most 1 (a sampled id has no
        embedding to feed back, as in the JAX package);
        ``cache`` a dense cache of ``max_len`` rows holding positions before
        ``start_pos`` — with graphs it must be ``burst_cache(B)``, the one
        the target was captured over. Each step's token and position stay
        on the device and feed the next step (with graphs: inside the
        graph's own inputs, so a step copies nothing in); each token is
        copied into a ``[B, num_tokens]`` device buffer, pulled once at the
        end. ``rng`` is the burst's key (``[2]`` int32, uint32 bits; zeros
        if None, as in the JAX package): the prologue splits it into one
        key per step, so a sampled burst's tokens equal the JAX engine's.
        ``on_step(i, tok)`` observes each step's tokens in that
        buffer as they are issued — e.g. to timestamp the first token
        without serialising the rest of the loop."""
        exe = self._current
        if exe is None:
            raise DispatchError("set_mode() before decode_loop() (cold path)")
        tokens = self.cfg.input_kind == "tokens"
        tok = torch.as_tensor(first_token).to(
            self.device, torch.int32 if tokens else dtype_of(self.cfg))
        if not tokens and tok.dim() == 2:  # [B,D] -> [B,1,D]
            tok = tok[:, None]
        batch = int(tok.shape[0])
        if num_tokens <= 0:
            return np.zeros((batch, 0), np.int32), cache
        if not tokens and num_tokens > 1:
            raise ValueError(
                f"{self.cfg.name} has a stub modality frontend (no token "
                f"embedding table): sampled ids cannot be fed back as "
                f"embeddings, so decode_loop supports num_tokens=1 only."
            )
        if isinstance(exe, _GraphStep) and cache is not exe.graph.owned:
            raise ValueError(
                f"decode_loop: the burst target of bucket {batch} was "
                f"captured over Engine.burst_cache({batch}); copy the cache "
                f"into it (after set_mode) and pass that"
            )
        base_key = (torch.zeros(2, dtype=torch.int32) if rng is None
                    else torch.as_tensor(rng, dtype=torch.int32).cpu())
        # one key per step, derived in the prologue (one upload)
        step_keys = prng.split(base_key, num_tokens).to(self.device)
        # Burst/continuous report parity (DESIGN.md §14): burst steps feed
        # the same registry families the batcher lanes do, under the
        # "burst" lane label.
        if self._burst_calls is None:
            reg = self.telemetry.registry
            self._burst_calls = reg.counter("lane_calls_total", lane="burst")
            self._burst_hist = reg.histogram("lane_step_ms", lane="burst")
        rec = self.telemetry.trace_or_none()
        pos = torch.tensor(start_pos, dtype=torch.int32, device=self.device)
        out = torch.empty((batch, num_tokens), dtype=torch.int32,
                          device=self.device)
        for i in range(num_tokens):
            t0_ns = time.perf_counter_ns()
            nxt, cache, tok, pos = exe(cache, tok, pos, step_keys[i])
            out[:, i].copy_(nxt)  # a graph's next replay overwrites nxt
            dt_ns = time.perf_counter_ns() - t0_ns
            self._burst_calls.inc()
            self._burst_hist.observe(dt_ns / 1e6)
            if rec is not None:
                rec.emit(
                    "lane_step", "lane:burst", ph="X",
                    ts_ns=t0_ns, dur_ns=dt_ns, args={"step": i},
                )
            if on_step is not None:
                on_step(i, out[:, i])
            self.stats["hot_calls"] += 1
        self.stats["tokens"] += num_tokens * batch
        toks, _ = steps_mod.pull_host(out, rec)
        return toks, cache

    # ---------------------------------------------------- paged continuous
    def paged_continuous(
        self,
        *,
        slots: int | None = None,
        seed: int = 0,
        spec_decode: bool | None = None,
        kv_dtype: str | None = None,
        draft_kv_dtype: str | None = None,
        async_steps: bool = False,
        async_depth: int = 2,
    ) -> PagedContinuousBatcher:
        """Cold path: build the page pool + prefix cache, warm every enabled
        paged lane key through the registry — every warmed page dtype, and
        with speculation every k bucket and draft dtype — and return a paged
        batcher (DESIGN.md §9-§12). The batcher's per-slot keys come from a
        numpy generator seeded with ``seed``; ``async_steps`` pipelines its
        steps (``async_depth`` issued steps at most, DESIGN.md §13) over the
        same warmed keys. ``kv_dtype`` / ``draft_kv_dtype`` override the
        configured pool / draft dtypes and must be in the warmed sets;
        ``spec_decode`` overrides ``spec_k > 0``. A stack with a mamba slot
        raises at once: its state is per row, not pageable."""
        models.check_paged(self.cfg)
        if self.cfg.input_kind != "tokens":
            raise ValueError(
                f"{self.cfg.name}: continuous batching feeds sampled ids "
                f"back as inputs and needs a token-input arch."
            )
        s = slots or self.ecfg.max_batch
        ecfg = self.ecfg
        dt = kv_dtype or ecfg.kv_dtype
        if dt not in self._warm_kv_dtypes():
            raise ValueError(
                f"kv_dtype={dt!r} is not in the warmed set "
                f"{self._warm_kv_dtypes()}; add it to EngineConfig.kv_dtype/"
                f"kv_dtypes so its lanes are warmed (a cold pool dtype would "
                f"build mid-stream)."
            )
        ddt = draft_kv_dtype or ecfg.draft_kv_dtype
        if ddt not in self._warm_draft_kv_dtypes():
            raise ValueError(
                f"draft_kv_dtype={ddt!r} is not in the warmed set "
                f"{self._warm_draft_kv_dtypes()}; add it to EngineConfig."
                f"draft_kv_dtype/draft_kv_dtypes."
            )
        use_spec = (
            (ecfg.spec_k > 0 if spec_decode is None else spec_decode)
            and self._supports_spec_decode()
        )
        self._check_kernels()
        pool = PagePool(
            self.pool_pages, ecfg.page_size, kv_dtype=dt,
            telemetry=self.telemetry,
        )
        # a new batcher starts from an empty pool and draft caches, as a
        # fresh engine's; a batcher resident there is parked, not wiped
        owner = self._new_owner()
        owner.bank = self._reset_storage(("paged", dt), self.paged_cache(dt))
        owner.bank.seat(owner)
        if use_spec:
            self._reset_drafts(s, ddt, owner)
        ctx = _WarmCtx(spec=use_spec)
        self._warm_lanes("paged", s, ctx)

        def dispatch(pages_bucket: int) -> Callable:
            return self._decode.dispatch(lanes_mod.CBP.key(s, pages_bucket, dt))

        prefill_dispatch = None
        if self._supports_chunked_prefill():

            def prefill_dispatch(chunk_bucket: int) -> Callable:
                return self._decode.dispatch(
                    lanes_mod.PF.key(s, chunk_bucket, dt)
                )

        draft_dispatch = verify_dispatch = draft_prefill_dispatch = None
        if use_spec:
            draft_dispatch, verify_dispatch, draft_prefill_dispatch = (
                self._spec_dispatchers(
                    s, ddt, lambda k: lanes_mod.VF.key(s, k, dt), owner
                )
            )

        # pre-bind the hot slot to the smallest bucket (already warmed)
        self._decode.dispatch(lanes_mod.CBP.key(s, 1, dt))
        self.mark_warm_boundary()
        return PagedContinuousBatcher(
            dispatch_fn=dispatch,
            pool=pool,
            prefix_cache=PrefixCache(pool),
            cache=self.paged_cache(dt),
            num_slots=s,
            max_pages_per_req=self.max_pages_per_req,
            device=self.device,
            cache_copy=models.copy_cache_pages,
            seed=seed,
            prefill_dispatch=prefill_dispatch,
            prefill_chunk=ecfg.prefill_chunk,
            telemetry=self.telemetry,
            draft_dispatch=draft_dispatch,
            verify_dispatch=verify_dispatch,
            draft_prefill_dispatch=draft_prefill_dispatch,
            draft_cache=self.draft_cache(s, ddt) if use_spec else None,
            spec_k=ecfg.spec_k if use_spec else 0,
            async_steps=async_steps,
            async_depth=async_depth,
            storage=owner,
        )

    def _spec_dispatchers(self, slots: int, draft_kv_dtype: str,
                          verify_key: Callable[[int], tuple],
                          owner: _Owner):
        """The speculative lanes' dispatch closures over warmed keys: the
        draft lanes pin the draft dtype and make ``owner``'s draft state the
        resident one (the batcher calls its draft target right after),
        ``verify_key(k)`` is the engine's verify key (``vf`` over its pool
        dtype, or ``vfd``)."""
        s = slots
        bank = self._banks["draft", s, draft_kv_dtype]

        def draft_dispatch(k: int) -> Callable:
            bank.claim(owner)
            return self._decode.dispatch(lanes_mod.DR.key(s, k, draft_kv_dtype))

        def verify_dispatch(k: int) -> Callable:
            return self._decode.dispatch(verify_key(k))

        def draft_prefill_dispatch(chunk_bucket: int) -> Callable:
            bank.claim(owner)
            return self._decode.dispatch(
                lanes_mod.DRP.key(s, chunk_bucket, draft_kv_dtype)
            )

        return draft_dispatch, verify_dispatch, draft_prefill_dispatch

    # ---------------------------------------------------- dense continuous
    def continuous(
        self,
        *,
        slots: int | None = None,
        seed: int = 0,
        spec_decode: bool | None = None,
        draft_kv_dtype: str | None = None,
        async_steps: bool = False,
        async_depth: int = 2,
    ) -> ContinuousBatcher:
        """Cold path: warm every enabled dense lane key through the registry
        — ``cb``, ``pfd`` per chunk bucket, and with speculation ``vfd``,
        ``dr`` and ``drp`` per k bucket and chunk bucket — over the engine's
        dense cache of ``slots`` rows, and return a dense batcher
        (DESIGN.md §4/§10/§11). Joins, leaves, greedy/sample flips, chunk
        sizes and draft depths are then data or rebinds over warmed keys.
        The batcher's per-slot keys come from a numpy generator seeded with
        ``seed``; ``async_steps``/``async_depth`` as ``paged_continuous``;
        ``spec_decode`` overrides ``spec_k > 0``; ``draft_kv_dtype``
        overrides the configured draft dtype and must be in the warmed set.

        The batcher starts from the state the JAX package's warmup leaves:
        the cache zeroed, then one dummy ``cb`` step (a mamba slot's state
        carries it, and every later step of an idle slot, into the next
        occupant, as in the JAX package). The dummy runs of the warm pass
        are undone first, so that state is the same on every device,
        however many runs a capture takes."""
        if self.cfg.input_kind != "tokens":
            raise ValueError(
                f"{self.cfg.name}: continuous batching feeds sampled ids "
                f"back as inputs and needs a token-input arch."
            )
        s = slots or self.ecfg.max_batch
        ddt = draft_kv_dtype or self.ecfg.draft_kv_dtype
        if ddt not in self._warm_draft_kv_dtypes():
            raise ValueError(
                f"draft_kv_dtype={ddt!r} is not in the warmed set "
                f"{self._warm_draft_kv_dtypes()}; add it to EngineConfig."
                f"draft_kv_dtype/draft_kv_dtypes."
            )
        use_spec = (
            (self.ecfg.spec_k > 0 if spec_decode is None else spec_decode)
            and self._supports_spec_decode()
        )
        self._check_kernels()
        owner = self._new_owner()
        cache = self.dense_cache(s)
        owner.bank = self._reset_storage(("dense", s), cache)
        owner.bank.seat(owner)
        if use_spec:
            self._reset_drafts(s, ddt, owner)
        ctx = _WarmCtx(spec=use_spec)
        self._warm_lanes("dense", s, ctx)
        self.zero_cache(cache)
        key = lanes_mod.CB.key(s)
        step = self._decode.dispatch(key)  # binds the hot slot (warmed)
        self._warm_cb(key, step, ctx)  # on the zeroed cache, see above

        prefill_dispatch = None
        if self._supports_chunked_prefill():

            def prefill_dispatch(chunk_bucket: int) -> Callable:
                return self._decode.dispatch(
                    lanes_mod.PFD.key(s, chunk_bucket)
                )

        draft_dispatch = verify_dispatch = draft_prefill_dispatch = None
        if use_spec:
            draft_dispatch, verify_dispatch, draft_prefill_dispatch = (
                self._spec_dispatchers(
                    s, ddt, lambda k: lanes_mod.VFD.key(s, k), owner
                )
            )
        self.mark_warm_boundary()
        return ContinuousBatcher(
            step=step,
            num_slots=s,
            max_len=self.ecfg.max_len,
            cache=cache,
            device=self.device,
            seed=seed,
            prefill_dispatch=prefill_dispatch,
            prefill_chunk=self.ecfg.prefill_chunk,
            telemetry=self.telemetry,
            draft_dispatch=draft_dispatch,
            verify_dispatch=verify_dispatch,
            draft_prefill_dispatch=draft_prefill_dispatch,
            draft_cache=self.draft_cache(s, ddt) if use_spec else None,
            spec_k=self.ecfg.spec_k if use_spec else 0,
            async_steps=async_steps,
            async_depth=async_depth,
            storage=owner,
        )


# ----------------------------------------------------------- stream runners
def run_continuous_stream(
    eng: Engine,
    requests: list[Request],
    *,
    slots: int | None = None,
    seed: int = 0,
    clock: Clock | None = None,
    async_steps: bool = False,
    async_depth: int = 2,
) -> dict:
    """Drive a request stream through the dense continuous engine; return a
    report with the JAX package's keys (its mesh keys left out).

    The acceptance metric is ``compiles_after_warmup`` (on the card:
    captures after warmup): 0 for any mix of greedy and sampled requests,
    prompt lengths and draft depths once ``continuous`` has warmed.
    ``async_steps`` pipelines host scheduling against device execution
    (DESIGN.md §13; ``async_depth`` caps the in-flight steps); the token
    streams are the same either way."""
    cb = eng.continuous(slots=slots, seed=seed, async_steps=async_steps,
                        async_depth=async_depth)  # warmup first...
    clock = clock or Clock()  # ...so served latencies exclude it
    q = RequestQueue(requests)
    finished: list[Request] = []
    while q or cb.has_work:
        now = clock.now()
        due = q.pop_due(now, limit=cb.free_slots)
        if due:
            cb.admit(due, now=now)
        if cb.has_work:
            finished.extend(cb.step(now=clock.now()))
        else:
            nxt = q.next_arrival()
            if nxt is None:
                break
            clock.jump_to(nxt)  # idle: fast-forward to the next arrival
    finished.extend(cb.flush(clock.now()))  # commit any in-flight step
    report = latency_report(finished, batcher=cb)
    report.update(
        engine="continuous",
        async_steps=cb.async_steps,
        device=str(eng.device),
        attn_impl=eng.ecfg.attn_impl,
        cuda_graphs=eng.graphs,
        slots=cb.num_slots,
        steps=cb.stats.steps,
        occupancy=round(cb.stats.occupancy, 4),
        prefill_chunk=cb.prefill_chunk,
        prompt_tokens=cb.stats.prompt_tokens,
        prefill_chunks=cb.stats.prefill_chunks,
        chunk_bucket_crossings=cb.stats.chunk_bucket_crossings,
        h2d_uploads=cb.stats.h2d_uploads,
        spec_k=cb.spec_k,
        k_bucket_crossings=cb.stats.k_bucket_crossings,
        compiles_total=eng._decode.stats.misses,
        compiles_after_warmup=eng.post_warmup_compiles,
        rebinds=eng.post_warmup_rebinds,
    )
    return report


def run_burst_stream(
    eng: Engine,
    requests: list[Request],
    *,
    clock: Clock | None = None,
    seed: int = 0,
) -> dict:
    """Per-burst baseline: every burst pays ``set_mode`` (dispatch, a build
    on a key's first sight, a rebind) before its hot loop; mixed modes split
    into separate bursts because the mode is baked into the target. Every
    burst starts from a fresh cache at position 0 with each request's
    ``first_token``, on the bucket's own cache zeroed. Every burst, greedy
    or sampled, draws its key from one numpy generator seeded ``seed`` (0,
    the JAX package's), so sampled bursts equal the JAX engine's.
    """
    clock = clock or Clock()
    q = RequestQueue(requests)
    rng = np.random.default_rng(seed)
    finished: list[Request] = []
    compiles0 = eng._decode.stats.misses
    rebinds0 = eng._decode.stats.rebinds
    switches = 0
    while q:
        now = clock.now()
        due = q.pop_due(now)
        if not due:
            nxt = q.next_arrival()
            if nxt is None:
                break
            clock.jump_to(nxt)
            continue
        for r in due:
            if r.new_tokens > eng.ecfg.max_len:
                raise ValueError(
                    f"request {r.rid} wants {r.new_tokens} tokens but the "
                    f"engine's cache holds max_len={eng.ecfg.max_len}."
                )
        for bucket, greedy, chunk in form_bursts(
            due, quantum=eng.ecfg.batch_quantum, max_batch=eng.ecfg.max_batch
        ):
            info = eng.set_mode(  # cold path
                batch=len(chunk), sampling=GREEDY if greedy else SAMPLE
            )
            switches += 1
            b = info["bucket"]
            cache = eng.zero_cache(eng.burst_cache(b))
            first = torch.zeros((b, 1), dtype=torch.int32)
            for i, r in enumerate(chunk):
                first[i, 0] = r.first_token
                r.t_admit = clock.now()
            key = torch.from_numpy(
                rng.integers(0, 2**32, size=2, dtype=np.uint32).view(np.int32)
            )
            first_t: dict = {}

            def note_first(i, tok, _first_t=first_t):
                if i == 0:  # TTFT: when the first step's output exists
                    steps_mod.pull_host(tok)
                    _first_t["t"] = clock.now()

            toks, _ = eng.decode_loop(  # hot path
                cache, first.to(eng.device), 0,
                max(r.new_tokens for r in chunk), rng=key,
                on_step=note_first,
            )
            done_t = clock.now()
            for i, r in enumerate(chunk):
                r.tokens = [int(t) for t in toks[i, : r.new_tokens]]
                r.t_first = first_t.get("t", done_t)
                r.t_done = done_t
                finished.append(r)
    report = latency_report(finished)
    report.update(
        engine="burst",
        device=str(eng.device),
        attn_impl=eng.ecfg.attn_impl,
        cuda_graphs=eng.graphs,
        hot_calls=eng.stats["hot_calls"],
        mode_switches=switches,
        compiles_total=eng._decode.stats.misses,
        compiles_after_warmup=eng._decode.stats.misses - compiles0,
        rebinds=eng._decode.stats.rebinds - rebinds0,
    )
    return report


def run_paged_stream(
    eng: Engine,
    requests: list[Request],
    *,
    slots: int | None = None,
    seed: int = 0,
    clock: Clock | None = None,
    kv_dtype: str | None = None,
    async_steps: bool = False,
    async_depth: int = 2,
) -> dict:
    """Drive a request stream through the paged KV engine; return a report.

    The acceptance contract: zero builds after warmup (every bucket of
    every lane was warmed), and sharing lets peak *logical* tokens exceed
    the pool's physical capacity on shared-prefix traffic. ``kv_dtype``
    overrides the configured pool dtype (it must be in the warmed set).
    With ``EngineConfig.spec_k > 0`` the report's ``spec`` block carries
    drafted/accepted tokens, the acceptance rate and k-bucket crossings.
    ``async_steps``/``async_depth`` as ``run_continuous_stream``.
    """
    cb = eng.paged_continuous(slots=slots, seed=seed, kv_dtype=kv_dtype,
                              async_steps=async_steps,
                              async_depth=async_depth)
    clock = clock or Clock()  # ...so served latencies exclude it
    q = RequestQueue(requests)
    finished: list[Request] = []
    peak_share: dict = {"share_ratio": 1.0, "overcommit_ratio": 0.0,
                        "logical_tokens": 0}
    peak_concurrent = 0
    stall_steps = 0
    while q or cb.has_work:
        now = clock.now()
        due = q.pop_due(now, limit=cb.free_slots)
        deferred: list[Request] = []
        if due:
            deferred = cb.admit(due, now=now)
            for r in deferred:
                q.submit(r)  # deferred for pages: retried, never rejected
        if cb.has_work:
            finished.extend(cb.step(now=clock.now()))
            for r in cb.preempted:
                q.submit(r)
            cb.preempted.clear()
            peak_concurrent = max(peak_concurrent, cb.active_count)
            share = sharing_report(cb.live_tables(), cb.pool)
            if share["logical_tokens"] >= peak_share["logical_tokens"]:
                peak_share = share
            stall_steps = 0
            continue
        if deferred:
            # queued work but nothing admissible and nothing running: drop
            # idle prefix pages and retry before declaring a stall
            if cb.prefix.evict(cb.pool.num_pages) == 0:
                stall_steps += 1
                if stall_steps > 2:
                    break  # pool too small for any queued request
            continue
        nxt = q.next_arrival()
        if nxt is None:
            break
        clock.jump_to(nxt)  # idle: fast-forward to the next arrival
    finished.extend(cb.flush(clock.now()))  # commit any in-flight step
    report = latency_report(finished, batcher=cb)
    report.update(
        engine="paged",
        async_steps=cb.async_steps,
        device=str(eng.device),
        attn_impl=eng.ecfg.attn_impl,
        cuda_graphs=eng.graphs,
        slots=cb.num_slots,
        steps=cb.stats.steps,
        occupancy=round(cb.stats.occupancy, 4),
        page_size=cb.pool.page_size,
        kv_dtype=cb.pool.kv_dtype,
        pool_pages=cb.pool.num_pages,
        pool_tokens=cb.pool.total_tokens,
        pages_in_use_peak=cb.pool.stats.peak_in_use,
        peak_concurrent=peak_concurrent,
        peak_logical_tokens=peak_share["logical_tokens"],
        share_ratio=round(peak_share["share_ratio"], 4),
        overcommit_ratio=round(peak_share["overcommit_ratio"], 4),
        shared_prompt_tokens=cb.stats.shared_tokens,
        prompt_tokens=cb.stats.prompt_tokens,
        # throughput incl. ingested prompt work (``tok_per_s`` counts only
        # emitted tokens)
        proc_tok_per_s=(
            round(
                (report.get("tokens", 0) + cb.stats.prompt_tokens)
                / report["span_s"],
                1,
            )
            if report.get("span_s")
            else 0.0
        ),
        preemptions=cb.stats.preemptions,
        starved_admissions=cb.stats.starved_admissions,
        rejected_oversize=cb.stats.rejected_oversize,
        bucket_crossings=cb.stats.bucket_crossings,
        prefill_chunk=cb.prefill_chunk,
        prefill_chunks=cb.stats.prefill_chunks,
        chunk_bucket_crossings=cb.stats.chunk_bucket_crossings,
        h2d_uploads=cb.stats.h2d_uploads,
        spec_k=cb.spec_k,
        k_bucket_crossings=cb.stats.k_bucket_crossings,
        cow_copies=cb.pool.stats.cow_copies,
        prefix_evictions=cb.pool.stats.prefix_evictions,
        unserved=len(requests) - len(finished),
        compiles_total=eng._decode.stats.misses,
        compiles_after_warmup=eng.post_warmup_compiles,
        rebinds=eng.post_warmup_rebinds,
    )
    return report


def run_overload_stream(
    eng: Engine,
    requests: list[Request],
    *,
    slots: int | None = None,
    seed: int = 0,
    clock: Clock | None = None,
    kv_dtype: str | None = None,
    async_steps: bool = False,
    capacity: int | None = None,
    shed_policy: str = "reject-new",
    queue_ttl_s: float | None = None,
    controller: DegradeController | None = None,
    degrade: bool = False,
    faults=None,
    watchdog: bool = True,
    heartbeat_timeout_steps: float = 2.0,
    max_steps: int | None = None,
) -> dict:
    """The overload-hardened paged stream (DESIGN.md §15).

    Everything ``run_paged_stream`` does, plus the hardening surfaces:

    * **bounded admission** — an ``runtime.admission.AdmissionQueue`` with
      ``capacity``/``shed_policy``/``queue_ttl_s``;
    * **deadlines** — per-request ``ttl_s`` sheds in queue, ``deadline_s``
      cancels mid-stream (the batcher's ``_cancel_overdue``);
    * **degradation ladder** — a ``runtime.degrade.DegradeController``
      observed once per iteration; its rung changes actuate ``set_knobs``
      over already-warmed keys, and an ``int8-pool`` rung routes *new
      admissions* to a pre-warmed int8 standby batcher while the other
      drains (pools flip at the admission boundary — a live cache is never
      requantised);
    * **fault injection** — an armed ``core.faults.FaultPlan`` is attached
      to the dispatcher (``build``), pools (``pool_alloc``) and batchers
      (``step_output``/``d2h_stall``); ``heartbeat`` is driven here: each
      iteration beats a ``ft.failover.HeartbeatMonitor`` on a *step-count*
      time axis (deterministic under any clock), a fired fault suppresses
      the beat, and a lost heartbeat forces the controller to the bottom
      rung until beats resume;
    * **watchdog** — ``ft.failover.StepTimeWatchdog`` wired into the step
      loop (wall time); stragglers feed the controller.

    With every knob at its default (no capacity, no TTL, no controller, no
    faults) this is behaviourally ``run_paged_stream``: the hardened loop
    is inert until configured. The clock is read where the JAX package's
    loop reads it, so one deterministic clock drives both alike.
    """
    registry = eng.telemetry.registry
    trace = eng.telemetry.trace_or_none()
    if faults is not None and faults.registry is None:
        faults.registry = registry
    if faults is not None:
        eng.attach_faults(faults)

    cb = eng.paged_continuous(  # warmup builds first
        slots=slots, seed=seed, kv_dtype=kv_dtype, async_steps=async_steps
    )
    base = Rung(
        "base",
        spec_k=cb.spec_k,
        prefill_chunk=cb.prefill_chunk,
        token_budget=cb.token_budget,
        kv_dtype=cb.pool.kv_dtype,
    )
    ctrl = controller
    if ctrl is None and degrade:
        ctrl = DegradeController(
            default_ladder(
                spec_k=cb.spec_k,
                prefill_chunk=cb.prefill_chunk,
                token_budget=cb.token_budget,
                int8_pool=(
                    "int8" in eng._warm_kv_dtypes()
                    and cb.pool.kv_dtype != "int8"
                ),
            ),
            registry=registry,
            trace=trace,
            queue_high=max(2 * cb.num_slots, 8),
            queue_low=max(cb.num_slots // 2, 1),
        )
    # int8 standby: warm the flip target *before* the warm boundary
    # settles, so an int8-pool rung crossing is pure admission routing
    cb8 = None
    if ctrl is not None and any(
        r.kv_dtype == "int8" for r in ctrl.rungs
    ) and base.kv_dtype != "int8":
        cb8 = eng.paged_continuous(
            slots=slots, seed=seed, kv_dtype="int8",
            async_steps=async_steps,
        )
    batchers = [b for b in (cb, cb8) if b is not None]
    if faults is not None:
        for b in batchers:
            b.attach_faults(faults)
            b.pool.attach_faults(faults)
    if watchdog:
        straggled = {"now": False}

        def _on_straggler(dt_s: float) -> None:
            straggled["now"] = True

        for b in batchers:
            b.attach_watchdog(StepTimeWatchdog(), _on_straggler)
    monitor = HeartbeatMonitor(
        ["engine"], timeout_s=heartbeat_timeout_steps
    )
    hb_lost = False

    clock = clock or Clock()
    # Open-loop traffic: ``pending`` holds requests that have not *arrived*
    # yet; the bounded AdmissionQueue only ever sees arrived requests, so
    # capacity/TTL/shedding act on actual queue wait.
    pending = RequestQueue(requests)
    q = AdmissionQueue(
        (),
        capacity=capacity,
        shed_policy=shed_policy,
        queue_ttl_s=queue_ttl_s,
        registry=registry,
        trace=trace,
    )
    active = cb  # admission target; rung crossings may re-route it
    finished: list[Request] = []
    stall_steps = 0
    steps = 0

    def _has_work() -> bool:
        return any(b.has_work for b in batchers)

    while pending or q or _has_work():
        if max_steps is not None and steps >= max_steps:
            break
        steps += 1
        now = clock.now()
        for r in pending.pop_due(now):
            q.submit(r)  # arrival: the shed policy applies here
        # --- heartbeat (step-count time axis: deterministic) -------------
        beat = True
        if faults is not None and faults.fire("heartbeat") is not None:
            beat = False
        if beat:
            monitor.beat("engine", t=float(steps))
        healthy = not monitor.failed(now=float(steps))
        if not healthy and not hb_lost:
            hb_lost = True
            if faults is not None:
                faults.note_detected("heartbeat")
        elif healthy and hb_lost:
            hb_lost = False
            if faults is not None:
                # beats resumed and the stream kept serving: contained
                faults.note_contained("heartbeat")
        # --- controller ---------------------------------------------------
        if ctrl is not None:
            rung = ctrl.observe(
                now,
                queue_depth=len(q),
                pool_frac=active.pool.pages_in_use / active.pool.num_pages,
                straggler=watchdog and straggled["now"],
                healthy=healthy,
            )
            if watchdog:
                straggled["now"] = False
            if rung is not None:
                for b in batchers:
                    apply_rung(b, rung, base)
                active = (
                    cb8
                    if (rung.kv_dtype == "int8" and cb8 is not None)
                    else cb
                )
        # --- admission ----------------------------------------------------
        due = q.pop_due(now, limit=active.free_slots)
        if due:
            for r in active.admit(due, now=now):
                q.submit(r)  # deferred for pages: retried, never rejected
        # --- step every batcher that holds work ---------------------------
        stepped = False
        for b in batchers:
            if not b.has_work:
                continue
            stepped = True
            finished.extend(b.step(now=clock.now()))
            for r in b.preempted:
                q.submit(r)
            b.preempted.clear()
            for r in b.requeued:  # quarantined: restart from scratch
                q.submit(r)
            b.requeued.clear()
        if stepped:
            stall_steps = 0
            continue
        if q:
            # arrived work but nothing admitted: reclaim prefix pages,
            # then declare a stall (pool too small for anything queued)
            if active.prefix.evict(active.pool.num_pages) == 0:
                stall_steps += 1
                if stall_steps > 2:
                    break
            continue
        nxt = pending.next_arrival()
        if nxt is None:
            break
        clock.jump_to(nxt)  # idle: fast-forward to the next arrival
    now = clock.now()
    for b in batchers:
        finished.extend(b.flush(now))
    if ctrl is not None:
        ctrl.finalize(now)
    # pool_alloc containment is the pre-existing evict/preempt/defer
    # machinery; if the stream drained (no injected exhaustion wedged it),
    # every injected alloc failure was absorbed.
    if faults is not None and not q and not pending:
        n_pa = sum(1 for site, _ in faults.injected if site == "pool_alloc")
        for _ in range(n_pa - faults.contained.get("pool_alloc", 0)):
            faults.note_contained("pool_alloc")

    cancelled = [r for b in batchers for r in b.cancelled_requests]
    failed = [r for b in batchers for r in b.failed_requests]
    report = latency_report(finished, batcher=cb, registry=registry)
    report.update(
        engine="overload",
        async_steps=cb.async_steps,
        slots=cb.num_slots,
        steps=sum(b.stats.steps for b in batchers),
        kv_dtype=active.pool.kv_dtype,
        capacity=capacity,
        shed_policy=shed_policy,
        shed=len(q.shed),
        cancelled=len(cancelled),
        failed=len(failed),
        deadline_missed=sum(b.stats.deadline_missed for b in batchers),
        stragglers=sum(b.stats.stragglers for b in batchers),
        preemptions=sum(b.stats.preemptions for b in batchers),
        unserved=len(requests)
        - len(finished) - len(q.shed) - len(cancelled) - len(failed),
        degrade_rung=(ctrl.rung.name if ctrl is not None else None),
        degrade_transitions=(
            [
                {"t": round(t, 4), "from": a, "to": b_, "why": w}
                for t, a, b_, w in ctrl.transitions
            ]
            if ctrl is not None
            else []
        ),
        faults=(faults.report() if faults is not None else None),
        compiles_total=eng._decode.stats.misses,
        compiles_after_warmup=eng.post_warmup_compiles,
        rebinds=eng.post_warmup_rebinds,
    )
    return report
