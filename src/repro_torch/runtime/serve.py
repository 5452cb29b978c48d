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
``chunk_bucket`` and ``draft_kv_dtype`` for the ``dr``/``drp`` draft lanes,
and ``op`` and ``kv_dtype`` for the ``mg`` page transport; every lane that
touches a pool ends with its ``mesh`` — with the attention implementation
(``EngineConfig.attn_impl``) and a MoE stack's dispatch policy
(``EngineConfig.moe_policy``) baked in when it is built. On the card
(``EngineConfig.cuda_graphs``, on by default there) a target is a
``core.graph_target.GraphTarget``: the step captured once as a CUDA graph
over static input and output buffers and over the engine's own state — one
page pool per (page dtype, mesh), one dense target cache per (slot count,
mesh), one dense draft cache per (slots, draft dtype, mesh), one burst
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

The **mesh coordinate** (DESIGN.md §16-§17): each warmed mesh name
(``EngineConfig.mesh``/``meshes``) is a cell of its own — its own pools and
dense caches on its device (``"1x1"`` the engine's, a slice ``"1x1@OFF"``
``EngineConfig.devices[OFF]``, which may name the same card) and its own
captured targets — so ``set_mesh`` copies a batcher's live state into the
target cell and flips the hot slot, never rebinding a captured tensor.
``paged_continuous(disagg=...)`` splits prefill from decode: the prefill
lanes run on the prefill slice's pool, and a prompt's pages migrate to the
decode pool at its flip (the ``mg`` targets). A plan of more than one
logical device ("1x2", "2x2", ...: ``devices[off : off + dp·mp]``, which
may all name one card) serves every lane of both continuous engines for
attention stacks with MLP or MoE tails (the MoE tail under the engine's
``moe_policy``, its experts split over ``model``) — ``cbp``, ``pf`` and ``vf`` over model-dtype and int8
pools, ``cb``, ``pfd`` and ``vfd`` over the dense cache, and the draft's
``dr`` and ``drp`` — with tensor-parallel weights over ``model``, the
pool's page blocks and the dense caches' slots over ``data`` and their kv
heads (else a dense cache's sequence) over ``model``
(``models.tensor_parallel``); each such mesh is a cell with its own pool,
dense and draft caches and targets, and on the card each key is still one
CUDA graph. ``set_mesh`` copies the live pages and dense rows between the
layouts. A split's slices may be such meshes too, of any layouts (decode
"1x2" beside prefill "1x2@2", or "2x1" beside "1x1@2"): the ``mg``
targets move a request's pages in the global layout between them. SSM
and hybrid stacks and plans across distinct cards raise
``NotImplementedError`` (ROADMAP A12 part 3); an embeddings arch is
refused by both continuous engines with the JAX package's ``ValueError``
on any plan (the burst engine serves it on the engine's device).

With ``Telemetry(compile_analysis=True)`` each build appends the key's
capture report (``capture_analysis``) with its roofline terms
(``roofline``).

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

from repro_torch import capture_analysis, models, perf, prng, roofline
from repro_torch.configs import ArchConfig
from repro_torch.kernels import build as kernel_build
from repro_torch.models import tensor_parallel
from repro_torch.core import DispatchError, DispatchPolicy, Dispatcher
from repro_torch.core import bucket_multiple
from repro_torch.core.graph_target import GraphTarget, check_args
from repro_torch.core import lanes as lanes_mod
from repro_torch.core.lanes import LANES
from repro_torch.core.telemetry import Telemetry
from repro_torch.distributed import sharding as shd
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
    _static_inputs,
    _upload,
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
    # The continuous batchers' per-step token budget (DESIGN.md §11): 0 =
    # one per slot plus one full prefill chunk.
    token_budget: int = 0
    # The serving mesh (DESIGN.md §16-§17): the active topology and the
    # standby names to warm, each a trailing key coordinate of every lane
    # that touches a pool: "1x1" (the engine's own device), slices
    # "1x1@OFF" (``devices[OFF]``) and plans "DPxMP[@OFF]" of more than one
    # logical device (``devices[OFF : OFF + DP*MP]``; the dense family's
    # lanes, all on one card).
    mesh: str = "1x1"
    meshes: tuple = ()
    # The engine's logical devices, which meshes index: () = each visible
    # device of the engine's type (every CUDA card, or "cpu" once). One
    # device may be named several times (("cuda:0",) * 4 is a 2x2 plan on
    # one card).
    devices: tuple = ()


@dataclass
class _WarmCtx:
    """State threaded through one warmup pass: the batcher's speculation
    opt-in. The dummy runs feed zero keys, so warmup draws nothing from the
    stream's seed, and write into the engine's own caches: the pools' null
    page only, the dense caches' rows at position 0 (and a mamba slot's
    state)."""

    spec: bool = False
    disagg: bool = False  # the batcher's disaggregation opt-in (§17)


class _Owner:
    """A batcher's claim on the engine storage its targets run over: held
    by the batcher (``storage``) and its draft dispatch closures, so it
    lives as long as the batcher. ``banks`` are its page pool's (both
    slices' pools under disaggregation) or dense cache's, claimed at the top
    of each of its steps (the draft cache's is claimed where a draft lane is
    dispatched). ``mirror`` is the batcher's
    device mirror (``scheduler._DeviceMirror``, set by the batcher),
    detached whenever another batcher's calls, or a new batcher's warmup,
    are about to replay targets whose static inputs it may hold."""

    __slots__ = ("banks", "mirror", "__weakref__")

    def __init__(self) -> None:
        self.banks: list[_StorageBank] = []
        self.mirror = None

    def detach(self) -> None:
        if self.mirror is not None:
            self.mirror.detach()

    def claim(self) -> None:
        """Put this batcher's state back into its pools or dense cache."""
        for bank in self.banks:
            bank.claim(self)


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

    def leave(self, owner: _Owner) -> None:
        """``owner`` moved its state to another set (a mesh rebind): it is
        resident here no more and keeps no parked copy."""
        if self._resident() is owner:
            self._owner = None
        self._parked.pop(owner, None)


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
    """The per-burst engine and the dense and paged serving lanes, on one
    device, on one-device mesh slices of the engine's devices, or (the
    continuous engines' lanes) on meshes of several logical devices."""

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
        # mesh plans by name, the weights per mesh device (§16-§17), and
        # tensor-parallel weight pieces (shared by every mesh of one model
        # size on one card)
        self._mesh_plans: dict[str, shd.MeshPlan] = {}
        self._mesh_params: dict = {}
        self._tp_pieces: dict = {}
        self._last_target = None  # the capture report's input (_build)
        # the engine's own state, which graph targets are captured over
        self._paged_caches: dict = {}  # (kv_dtype, mesh) -> page pool
        self._dense_caches: dict = {}  # (slots, mesh) -> dense target cache
        # (slots, draft dtype, mesh) -> dense draft cache
        self._draft_caches: dict = {}
        # whose state each of those tensor sets holds (C13): ("paged",
        # dtype, mesh) / ("dense", slots, mesh) / ("draft", slots, dtype,
        # mesh)
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
        lane or malformed key raises ``UnknownLaneError`` here. With
        ``Telemetry.compile_analysis`` on, the key's capture report
        (``capture_analysis.analyze_target``: one counted eager run of the
        step on the key's shapes, after the build) is appended to
        ``telemetry.compile_reports`` with the build (on the card: capture)
        time as ``build_ms`` and the key's roofline terms (DESIGN.md §14)."""
        spec = LANES.spec_for(key)
        if not self.telemetry.compile_analysis:
            return getattr(self, spec.builder)(*spec.coords(key))
        self._last_target = None
        t0 = time.perf_counter()
        exe = getattr(self, spec.builder)(*spec.coords(key))
        build_ms = (time.perf_counter() - t0) * 1e3
        rep = self._capture_report()
        rep["key"] = str(key)
        rep["lane"] = spec.name
        rep["build_ms"] = round(build_ms, 3)
        self.telemetry.compile_reports.append(rep)
        return exe

    def _capture_report(self) -> dict:
        """The last built target's capture report (one device's, on a mesh
        the busiest's, with its collectives' bytes) and its roofline terms:
        ``chips`` = the mesh's devices, ``model_flops`` = a device's flops
        times the devices, ``min_bytes_global`` = the weights plus the
        key's cache extent. A failure is an ``{"error": ...}`` report,
        never a failed build."""
        last = self._last_target
        if last is None:
            return {"error": "no target was built"}
        step, params, cache, args, extent, weights, chips = last
        rep = capture_analysis.analyze_target(step, params, cache, *args)
        if "error" in rep:
            return rep
        rep["chips"] = chips
        rep["cache_extent_bytes"] = extent
        rep["param_bytes"] = sum(t.numel() * t.element_size()
                                 for t in weights.values())
        rep["roofline"] = roofline.roofline_terms({
            "flops_per_device": rep["flops"],
            "bytes_per_device": rep["bytes"],
            "collective_bytes_per_device": rep["collectives"],
            "chips": chips,
            "model_flops": rep["flops"] * chips,
            "min_bytes_global": rep["param_bytes"] + extent,
        }, dtype=dtype_of(self.cfg))
        return rep

    # ------------------------------------------------------- mesh plans
    @property
    def devices(self) -> tuple[torch.device, ...]:
        """The engine's logical devices (``EngineConfig.devices``; default
        each visible device of the engine's type)."""
        if self.ecfg.devices:
            devs = tuple(torch.device(d) for d in self.ecfg.devices)
        elif self.device.type == "cuda":
            devs = tuple(torch.device("cuda", i)
                         for i in range(torch.cuda.device_count()))
        else:
            devs = (torch.device("cpu"),)
        for d in devs:
            if d.type != self.device.type:
                raise ValueError(
                    f"EngineConfig.devices: {d} is not a {self.device.type} "
                    f"device, as the engine's {self.device} is"
                )
        return devs

    def _mesh_plan(self, name: str) -> shd.MeshPlan:
        """The plan of a mesh name, checked where an engine warms or binds
        it: a plan past ``devices`` raises ``ValueError``; a plan of more
        than one device whose devices span distinct cards, or whose model
        the tensor-parallel path does not serve, ``NotImplementedError``."""
        nm = shd.mesh_name(*shd.parse_slice_name(name))
        plan = self._mesh_plans.get(nm)
        if plan is None:
            plan = shd.MeshPlan(nm, self.devices)
            if plan.solo:
                plan.device  # noqa: B018 - the check above
            else:
                cards = sorted({str(d) for d in plan.mesh.devices})
                if len(cards) > 1:
                    raise NotImplementedError(
                        f"mesh {nm!r} spans the distinct devices {cards}: "
                        f"plans across cards wait for {shd.PART3}; name one "
                        f"card for every logical device")
                tensor_parallel.check_family(self.cfg)
            self._mesh_plans[nm] = plan
        return plan

    def _multi(self, mesh: str) -> bool:
        """Whether ``mesh`` is a plan of more than one logical device."""
        return not self._mesh_plan(mesh).solo

    def _mesh_device(self, mesh: str) -> torch.device:
        """The device a mesh's targets and storage live on: the engine's
        own for ``"1x1"``, ``devices[OFF]`` for a slice ``"1x1@OFF"``, the
        first of a multi-device plan's (where its steps' per-slot inputs
        and outputs live)."""
        plan = self._mesh_plan(mesh)
        return self.device if plan.single else torch.device(plan.device)

    def _layout(self, mesh: str, slots: int, *, paged: bool = True
                ) -> "tensor_parallel.TPLayout | None":
        """A multi-device plan's tensor-parallel layout for ``slots`` (the
        draft's too: its layers have the target's shapes); None for a
        one-device mesh. A dense cache's layout has no page blocks."""
        if not self._multi(mesh):
            return None
        plan = self._mesh_plan(mesh)
        return tensor_parallel.layout_for(
            self.cfg, plan.param_specs(self.params), plan, slots,
            self.pool_physical_pages if paged else 0)

    def _params_for_mesh(self, mesh: str, *, draft: bool = False) -> dict:
        """The weights as a mesh's targets take them, moved to its device
        once (``.to()`` onto the engine's own device returns each tensor
        itself, so a slice on the same card shares the weights); for a
        multi-device plan, each coordinate's (``tensor_parallel.
        shard_params``: replicated weights shared, pieces once per card and
        model size; the draft's are views of the target's,
        ``tensor_parallel.draft_shards``)."""
        base = self.draft_params if draft else self.params
        if self._multi(mesh):
            plan = self._mesh_plan(mesh)
            key = ("mesh", plan.name, draft)
            if key not in self._mesh_params:
                self._mesh_params[key] = (
                    tensor_parallel.draft_shards(
                        self._params_for_mesh(mesh), self.draft_cfg)
                    if draft else tensor_parallel.shard_params(
                        base, plan.param_specs(base), plan.mesh,
                        self._tp_pieces))
            return self._mesh_params[key]
        dev = self._mesh_device(mesh)
        key = (str(dev), draft)
        hit = self._mesh_params.get(key)
        if hit is None:
            hit = self._mesh_params[key] = {
                k: v.to(dev) for k, v in base.items()
            }
        return hit

    def _target(
        self, key: tuple, step: Callable, rows: dict, cache: list,
        cache_dtype: torch.dtype, *, mesh: str = "1x1", draft: bool = False,
        chain: dict | None = None, extent: int = 0,
    ) -> Callable:
        """A key's branch target: ``step`` bound to its weights (the
        target's, or the draft view's with ``draft``, on the mesh's
        device), to ``rows`` (name -> (shape, dtype) of each input after
        the cache) and to the cache dtype, called as ``target(cache,
        *rows)``. A call with another shape, dtype or device, or another
        cache dtype, is a dispatch bug and raises (the aval guard of a
        compiled executable). With graphs it is captured over ``cache``
        (the engine's own), with ``chain`` mapping outputs to the inputs
        they feed (the next token, positions and keys). ``extent`` is the
        bytes of ``cache`` the key's shapes address (its capture report's
        roofline floor).

        The target runs under the ``perf`` opts current when it is built,
        on every call (semi-static, as a traced step): with
        ``attn_impl="kernel"`` a sub-f32 ``score_dtype``/``probs_dtype``
        raises here, at build."""
        if self.ecfg.attn_impl == "kernel" and self.cfg.has_attention:
            perf.check_kernel_opts(f"{key}: attn_impl='kernel'")
        step = perf.bake(step)
        device = self._mesh_device(mesh)
        params = self._params_for_mesh(mesh, draft=draft)
        specs = [(n, tuple(shape), dt) for n, (shape, dt) in rows.items()]
        examples = [
            torch.ones(shape, dtype=dt, device=device)
            if dt.is_floating_point
            else torch.zeros(shape, dtype=dt, device=device)
            for _, shape, dt in specs
        ]
        if self.telemetry.compile_analysis:
            self._last_target = (step, params, cache, examples, extent,
                                 self.draft_params if draft else self.params,
                                 self._mesh_plan(mesh).num_devices)
        if not self.graphs:
            return self._guarded(step, specs, cache_dtype, params, device)
        names = [n for n, _, _ in specs]
        graph = GraphTarget(
            lambda *ins: step(params, cache, *ins), examples, owned=cache,
            pool=self._graph_pool, chain=chain, names=names, name=str(key),
        ).capture()
        return _GraphStep(graph)

    def _guarded(
        self, step: Callable, specs: list, cache_dtype: torch.dtype,
        params: dict, device: torch.device,
    ) -> Callable:
        """The eager target (CPU, or ``cuda_graphs=False``)."""

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

    @staticmethod
    def _extent(cache: list, pages: int | None = None) -> int:
        """Bytes of a cache a key's shapes address: ``pages`` pages of
        every leaf of a pool (page axis 1; a mesh's pages spread over its
        data rows), or the whole of a dense cache."""
        total = 0
        for layer in cache:
            for t in layer.values():
                n = t.numel() * t.element_size()
                total += n if pages is None else n // t.shape[1] * pages
        if pages is not None and isinstance(cache, models.ShardedCache):
            total //= cache.mesh.shape["data"]
        return total

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
        cache = self.burst_cache(batch)
        return self._target(
            lanes_mod.BURST.key(batch, mode), step,
            {"tok": self._burst_input(batch), "pos": ((), i32),
             "key": ((2,), i32)},
            cache, dtype_of(self.cfg),
            chain={2: 0, 3: 1} if tokens else {3: 1},
            extent=self._extent(cache),
        )

    def _burst_input(self, batch: int) -> tuple:
        """(shape, dtype) of a burst step's input: i32 token ids
        ``[B,1]``, or stub-frontend embeddings ``[B,1,D]`` in the model
        dtype for an embeddings arch."""
        if self.cfg.input_kind == "tokens":
            return (batch, 1), torch.int32
        return (batch, 1, self.cfg.d_model), dtype_of(self.cfg)

    def _build_slot_decode(self, slots: int, mesh: str = "1x1") -> Callable:
        """Branch target for ``("cb", slots, mesh)``: the dense continuous
        decode step over the engine's dense cache of ``slots`` rows on
        ``mesh``, every slot at its own position, sampling params as data
        (DESIGN.md §4). The next token, positions and keys feed its next
        call."""
        step = steps_mod.make_slot_decode_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
            layout=self._layout(mesh, slots, paged=False),
        )
        i32 = torch.int32
        cache = self.dense_cache(slots, mesh)
        return self._target(
            lanes_mod.CB.key(slots, mesh), step, {
                "tok": ((slots, 1), i32), "pos": ((slots,), i32),
                "active": ((slots,), torch.bool),
                **self._sampling_rows(slots),
            }, cache, dtype_of(self.cfg), mesh=mesh,
            chain={4: 0, 2: 1, 3: 5}, extent=self._extent(cache),
        )

    def _build_slot_prefill(self, slots: int, chunk_bucket: int,
                            mesh: str = "1x1") -> Callable:
        """Branch target for ``("pfd", slots, chunk_bucket, mesh)``: batched
        chunked prefill into the dense cache (DESIGN.md §10) — a slot's rows
        are a trivial identity block table, so the chunk-bucket machinery of
        the paged lane serves both engines."""
        step = steps_mod.make_slot_prefill_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
            layout=self._layout(mesh, slots, paged=False),
        )
        cache = self.dense_cache(slots, mesh)
        return self._target(
            lanes_mod.PFD.key(slots, chunk_bucket, mesh), step,
            self._dense_chunk_rows(slots, chunk_bucket), cache,
            dtype_of(self.cfg), mesh=mesh, chain={2: 5},
            extent=self._extent(cache),
        )

    def _build_slot_verify(self, slots: int, k: int,
                           mesh: str = "1x1") -> Callable:
        """Branch target for ``("vfd", slots, k, mesh)``: the dense verify
        pass (DESIGN.md §11), K+1 window rows through the dense chunk
        path."""
        step = steps_mod.make_slot_verify_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
            layout=self._layout(mesh, slots, paged=False),
        )
        cache = self.dense_cache(slots, mesh)
        return self._target(
            lanes_mod.VFD.key(slots, k, mesh), step,
            self._dense_chunk_rows(slots, k + 1), cache,
            dtype_of(self.cfg), mesh=mesh, chain={3: 5},
            extent=self._extent(cache),
        )

    def _build_paged_slot_decode(
        self, slots: int, pages_bucket: int, kv_dtype: str, mesh: str = "1x1"
    ) -> Callable:
        """Branch target for ``("cbp", slots, pages_bucket, kv_dtype,
        mesh)``: capacity is a semi-static condition (DESIGN.md §9) — the
        block table's width is part of the target's shapes, and outgrowing
        the bucket re-dispatches on the cold path; the page dtype is another
        (DESIGN.md §12), so model-dtype and int8 pools are two targets, and
        the mesh a third (DESIGN.md §16). The next token, positions and keys
        feed its next call."""
        step = steps_mod.make_paged_slot_decode_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
            layout=self._layout(mesh, slots),
        )
        i32 = torch.int32
        cache = self.paged_cache(kv_dtype, mesh)
        return self._target(
            lanes_mod.CBP.key(slots, pages_bucket, kv_dtype, mesh), step, {
                "tok": ((slots, 1), i32), "pos": ((slots,), i32),
                "block_tables": ((slots, pages_bucket), i32),
                "active": ((slots,), torch.bool),
                **self._sampling_rows(slots),
            }, cache, self._kv_torch_dtype(kv_dtype, self.cfg), mesh=mesh,
            chain={4: 0, 2: 1, 3: 6},
            extent=self._extent(cache, slots * pages_bucket),
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
        self, slots: int, chunk_bucket: int, kv_dtype: str, mesh: str = "1x1"
    ) -> Callable:
        """Branch target for ``("pf", slots, chunk_bucket, kv_dtype,
        mesh)``: batched chunked prefill (DESIGN.md §10). The chunk width is
        part of the shapes; the block table is pinned at the per-request
        page cap. Under disaggregation (§17) the batcher dispatches it on
        the prefill slice's mesh, over that slice's pool."""
        step = steps_mod.make_paged_prefill_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
            layout=self._layout(mesh, slots),
        )
        cache = self.paged_cache(kv_dtype, mesh)
        return self._target(
            lanes_mod.PF.key(slots, chunk_bucket, kv_dtype, mesh), step,
            self._chunk_rows(slots, chunk_bucket), cache,
            self._kv_torch_dtype(kv_dtype, self.cfg), mesh=mesh, chain={2: 6},
            extent=self._extent(cache, slots * self.max_pages_per_req),
        )

    def _build_paged_verify(self, slots: int, k: int, kv_dtype: str,
                            mesh: str = "1x1") -> Callable:
        """Branch target for ``("vf", slots, k, kv_dtype, mesh)``: the
        target scores all K+1 window positions in one pass through the paged
        chunk path (DESIGN.md §11). The window width k+1 is part of the
        shapes; the block table is pinned at the per-request page cap."""
        step = steps_mod.make_paged_verify_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
            layout=self._layout(mesh, slots),
        )
        cache = self.paged_cache(kv_dtype, mesh)
        return self._target(
            lanes_mod.VF.key(slots, k, kv_dtype, mesh), step,
            self._chunk_rows(slots, k + 1), cache,
            self._kv_torch_dtype(kv_dtype, self.cfg), mesh=mesh, chain={3: 6},
            extent=self._extent(cache, slots * self.max_pages_per_req),
        )

    def _build_draft(self, slots: int, k: int, draft_kv_dtype: str,
                     mesh: str = "1x1") -> Callable:
        """Branch target for ``("dr", slots, k, draft_kv_dtype, mesh)``: K
        draft decode steps looped inside one target (DESIGN.md §11), so
        depth variation re-dispatches on the cold path; the draft cache's
        dtype is its own coordinate (DESIGN.md §16). Its keys are the
        batcher's, split and discarded (``steps.make_draft_fn``)."""
        step = steps_mod.make_draft_fn(
            self.draft_cfg, k=k, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
            layout=self._layout(mesh, slots, paged=False),
        )
        i32 = torch.int32
        cache = self.draft_cache(slots, draft_kv_dtype, mesh)
        return self._target(
            lanes_mod.DR.key(slots, k, draft_kv_dtype, mesh), step, {
                "tok": ((slots, 1), i32), "pos": ((slots,), i32),
                "active": ((slots,), torch.bool),
                **self._sampling_rows(slots),
            }, cache, self._kv_torch_dtype(draft_kv_dtype, self.draft_cfg),
            mesh=mesh, draft=True, extent=self._extent(cache),
        )

    def _build_draft_prefill(
        self, slots: int, chunk_bucket: int, draft_kv_dtype: str,
        mesh: str = "1x1",
    ) -> Callable:
        """Branch target for ``("drp", slots, chunk_bucket, draft_kv_dtype,
        mesh)``: the draft's prompt mirror — chunked dense ingestion over
        the draft view, so its cache tracks the prompts."""
        step = steps_mod.make_slot_prefill_fn(
            self.draft_cfg, attn_impl=self.ecfg.attn_impl,
            moe_policy=self.ecfg.moe_policy,
            layout=self._layout(mesh, slots, paged=False),
        )
        cache = self.draft_cache(slots, draft_kv_dtype, mesh)
        return self._target(
            lanes_mod.DRP.key(slots, chunk_bucket, draft_kv_dtype, mesh),
            step, self._dense_chunk_rows(slots, chunk_bucket), cache,
            self._kv_torch_dtype(draft_kv_dtype, self.draft_cfg),
            mesh=mesh, draft=True, extent=self._extent(cache),
        )

    def _build_migrate(self, op: str, kv_dtype: str = "fp32",
                       mesh: str = "1x1") -> Callable:
        """Branch target for ``("mg", op, kv_dtype, mesh)``: one half of
        the KV-page migration transport (DESIGN.md §17) over the mesh's
        pool of ``kv_dtype``. ``gather(cache, idx[B]) -> block`` reads B
        pages of every leaf (int8 scales ride along);
        ``scatter(cache, idx[B], *block)`` writes a block into the pool in
        place. B is pinned at the per-request page cap and short
        migrations pad ``idx`` with the null page, so the page count is
        never a coordinate: one pair of targets moves one page or a whole
        request. On a mesh's pool the block is in the global layout
        (``tensor_parallel.gather_mesh_pages``/``scatter_mesh_pages``), so
        the two slices of a split may have any layouts."""
        cache = self.paged_cache(kv_dtype, mesh)
        b = self.max_pages_per_req
        rows = {"idx": ((b,), torch.int32)}
        if op == "gather":
            step = steps_mod.make_page_gather_fn()
        elif op == "scatter":
            step = steps_mod.make_page_scatter_fn()
            for (i, n), leaf in zip(steps_mod.page_leaves(cache),
                                    steps_mod.page_block(cache, b)):
                rows[f"block {i}/{n}"] = leaf
        else:
            raise ValueError(f"unknown migration op {op!r}")
        return self._target(
            lanes_mod.MG.key(op, kv_dtype, mesh), step, rows, cache,
            self._kv_torch_dtype(kv_dtype, self.cfg), mesh=mesh,
            extent=self._extent(cache, b),
        )

    # ------------------------------------------------------ engine state
    def paged_cache(self, kv_dtype: str, mesh: str = "1x1") -> list:
        """The page pool of ``kv_dtype`` on ``mesh`` (null page included),
        created on first use on the mesh's device: every paged target of
        that (dtype, mesh) cell is bound to it. The two slices of a split
        hold two pools, distinct storage even on one card."""
        key = (kv_dtype, shd.mesh_name(*shd.parse_slice_name(mesh)))
        if key not in self._paged_caches:
            if self._multi(key[1]):  # the mesh's pieces of the pool
                self._paged_caches[key] = tensor_parallel.init_mesh_paged_cache(
                    self._mesh_plan(key[1]), models.init_paged_cache(
                        self.cfg, self.pool_physical_pages,
                        self.ecfg.page_size, kv_dtype, device="meta"))
            else:
                self._paged_caches[key] = models.init_paged_cache(
                    self.cfg, self.pool_physical_pages, self.ecfg.page_size,
                    kv_dtype, device=self._mesh_device(key[1]),
                )
        return self._paged_caches[key]

    def dense_cache(self, slots: int, mesh: str = "1x1") -> list:
        """The dense continuous engine's cache of ``slots`` rows of
        ``models.dense_rows(max_len)`` positions on ``mesh`` (model dtype;
        ``max_len`` rounded up to a multiple of 8, so its page view exists),
        created on first use: every ``cb``, ``pfd`` and ``vfd`` target of
        that slot count and mesh is bound to it, and ``continuous`` hands it
        to its batcher, which still admits requests by ``max_len``."""
        key = (slots, shd.mesh_name(*shd.parse_slice_name(mesh)))
        if key not in self._dense_caches:
            self._dense_caches[key] = self._new_dense_cache(
                self.cfg, slots, "fp32", key[1])
        return self._dense_caches[key]

    def _new_dense_cache(self, cfg: ArchConfig, slots: int, kv_dtype: str,
                         mesh: str) -> list:
        """A zeroed dense cache of ``slots`` rows of ``dense_rows(max_len)``
        positions on ``mesh``: on its device, or a multi-device plan's
        pieces (``tensor_parallel.init_mesh_dense_cache``)."""
        rows = models.dense_rows(self.ecfg.max_len)
        if self._multi(mesh):
            return tensor_parallel.init_mesh_dense_cache(
                self._mesh_plan(mesh), models.init_cache(
                    cfg, slots, rows, kv_dtype, device="meta"))
        return models.init_cache(cfg, slots, rows, kv_dtype,
                                 device=self._mesh_device(mesh))

    def draft_cache(self, slots: int, draft_kv_dtype: str,
                    mesh: str = "1x1") -> list:
        """The draft view's dense cache for ``slots`` rows of
        ``models.dense_rows(max_len)`` positions on ``mesh``, created on
        first use."""
        key = (slots, draft_kv_dtype,
               shd.mesh_name(*shd.parse_slice_name(mesh)))
        if key not in self._draft_caches:
            self._draft_caches[key] = self._new_dense_cache(
                self.draft_cfg, slots, draft_kv_dtype, key[2])
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

    def _reset_drafts(self, slots: int, draft_kv_dtype: str, mesh: str,
                      owner: _Owner) -> None:
        """A new speculating batcher on ``slots``: park every warmed draft
        (dtype, mesh) cell's resident state and zero those caches (its
        warmup writes them all); ``owner``'s state is the cell
        ``(draft_kv_dtype, mesh)``'s after the batcher's warmup."""
        for d in self._warm_draft_kv_dtypes():
            for m in self._warm_meshes():
                bank = self._reset_storage(("draft", slots, d, m),
                                           self.draft_cache(slots, d, m))
                if (d, m) == (draft_kv_dtype, mesh):
                    bank.seat(owner)

    def _move_storage(self, owner: _Owner, src_key: tuple,
                      dst: tuple) -> list:
        """A mesh rebind's data movement: ``owner``'s state in the set of
        bank ``src_key`` is copied into ``dst`` = (bank key, cache), the
        target cell's captured tensors (their resident batcher parked
        first), never rebinding a captured tensor; ``owner`` leaves its old
        set. Returns the target cache."""
        dst_key, target = dst
        src = self._banks[src_key]
        bank = self._banks.setdefault(dst_key, _StorageBank(target))
        bank.vacate()
        models.relayout_cache(target, src.cache)  # either layout to either
        bank.seat(owner)
        src.leave(owner)
        if src in owner.banks:  # a draft cache is claimed at its dispatch
            owner.banks[owner.banks.index(src)] = bank
        return target

    def _make_mesh_ctl(self, mesh_bind: dict, owner: _Owner,
                       cell: Callable[[str], tuple],
                       draft_cell: Callable[[str], tuple] | None,
                       hot_key: Callable) -> Callable:
        """The batcher's topology-flip closure (DESIGN.md §16):
        ``mesh_ctl(name, cache, draft_cache, **hot)`` validates the name
        against the warmed ladder, copies the live caches into the target
        mesh's cells (``cell(mesh)`` / ``draft_cell(mesh)`` -> (bank key,
        cache)), moves the shared mesh binding every dispatch closure reads
        and flips the decode hot slot with ``set_direction`` (``hot_key``
        maps the batcher's bucket state to the decode key under the new
        binding): a rebind, never a capture. Refused while disaggregated:
        the decode slice anchors the page pool."""
        warm = self._warm_meshes()

        def mesh_ctl(name: str, cache: list, draft_cache, **hot: Any):
            if "prefill" in mesh_bind:
                raise ValueError(
                    "cannot rebind the decode mesh while disaggregated "
                    "prefill/decode is configured (DESIGN.md §17): the "
                    "decode slice anchors the page pool; use set_disagg "
                    "to split/collapse instead."
                )
            nm = shd.mesh_name(*shd.parse_slice_name(name))
            if nm not in warm:
                raise ValueError(
                    f"mesh {nm!r} is not in the warmed set {warm}; add it "
                    f"to EngineConfig.mesh/meshes so its lanes are warmed "
                    f"(a cold topology would capture mid-stream)."
                )
            if nm != mesh_bind["mesh"]:
                now = mesh_bind["mesh"]
                cache = self._move_storage(owner, cell(now)[0], cell(nm))
                if draft_cache is not None:
                    draft_cache = self._move_storage(
                        owner, draft_cell(now)[0], draft_cell(nm))
                mesh_bind["mesh"] = nm
                self._decode.set_direction(hot_key(**hot))
                self.telemetry.registry.inc("mesh_rebinds_total")
                rec = self.telemetry.trace_or_none()
                if rec is not None:
                    rec.emit("mesh_rebind", "dispatcher", args={"mesh": nm})
            return nm, cache, draft_cache

        return mesh_ctl

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
    def pool_shards(self) -> int:
        """Page-pool shard count: the widest warmed data-parallel degree,
        which every other warmed mesh's dp must divide (so every warmed
        mesh's data rows hold whole shard blocks)."""
        meshes = self._warm_meshes()
        shards = max(shd.parse_mesh_name(m)[0] for m in meshes)
        for m in meshes:
            dp = shd.parse_mesh_name(m)[0]
            if shards % dp != 0:
                raise ValueError(
                    f"warmed mesh {m!r}: dp={dp} must divide the pool "
                    f"shard count {shards} (the widest warmed dp) so all "
                    f"topologies share one physical page layout."
                )
        return shards

    @property
    def pool_physical_pages(self) -> int:
        """Device page-axis extent: allocatable pages plus one null page
        per shard (``pool_pages + 1`` with one shard)."""
        shards = self.pool_shards
        if self.pool_pages % shards:
            raise ValueError(
                f"num_pages={self.pool_pages} must divide evenly across "
                f"{shards} pool shards; pad EngineConfig.num_pages to a "
                f"multiple."
            )
        return self.pool_pages + shards

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

    def _warm_meshes(self) -> tuple[str, ...]:
        """The mesh-axis ladder (DESIGN.md §16): the active topology plus
        every standby name to warm, canonicalised ("1,1" -> "1x1"; offset
        slices stay distinct) and deduped."""
        names = (self.ecfg.mesh,) + tuple(self.ecfg.meshes)
        return tuple(
            dict.fromkeys(
                shd.mesh_name(*shd.parse_slice_name(n)) for n in names
            )
        )

    def _check_meshes(self) -> None:
        """Every warmed mesh must be a plan the port runs, on a listed
        device (``_mesh_plan``): checked before a batcher warms anything."""
        for m in self._warm_meshes():
            self._mesh_plan(m)

    def _disagg_lanes_enabled(self, ctx: "_WarmCtx") -> bool:
        """The migration lane's gate: only a batcher that opted into
        disaggregated prefill/decode warms the transport."""
        return bool(ctx.disagg)

    def _mg_ops(self) -> tuple[str, ...]:
        """The migration lane's op ladder: the export gather and the import
        scatter (DESIGN.md §17)."""
        return ("gather", "scatter")

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
    def _zeros(self, *shape: int, dtype=torch.int32,
               device: torch.device | None = None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=device or self.device)

    def _warm_sampling(self, s: int, device: torch.device) -> tuple:
        return (
            torch.ones(s, dtype=torch.float32, device=device),
            torch.ones(s, dtype=torch.bool, device=device),
            self._zeros(s, 2, device=device),
        )

    def _warm_cb(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, m = key
        d = self._mesh_device(m)
        out = exe(
            self.dense_cache(s, m), self._zeros(s, 1, device=d),
            self._zeros(s, device=d),
            self._zeros(s, dtype=torch.bool, device=d),
            *self._warm_sampling(s, d),
        )
        steps_mod.pull_host(out[5])

    def _warm_pfd(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, cb, m = key
        d = self._mesh_device(m)
        out = exe(
            self.dense_cache(s, m), self._zeros(s, cb, device=d),
            self._zeros(s, device=d), self._zeros(s, device=d),
            *self._warm_sampling(s, d),
        )
        steps_mod.pull_host(out[3])

    def _warm_vfd(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, k, m = key
        d = self._mesh_device(m)
        out = exe(
            self.dense_cache(s, m), self._zeros(s, k + 1, device=d),
            self._zeros(s, device=d), self._zeros(s, device=d),
            *self._warm_sampling(s, d),
        )
        steps_mod.pull_host(out[4])

    def _warm_cbp(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, pb, dt, m = key
        d = self._mesh_device(m)
        out = exe(
            self.paged_cache(dt, m), self._zeros(s, 1, device=d),
            self._zeros(s, device=d), self._zeros(s, pb, device=d),
            self._zeros(s, dtype=torch.bool, device=d),
            *self._warm_sampling(s, d),
        )
        steps_mod.pull_host(out[5])

    def _warm_pf(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, cb, dt, m = key
        d = self._mesh_device(m)
        out = exe(
            self.paged_cache(dt, m), self._zeros(s, cb, device=d),
            self._zeros(s, device=d),
            self._zeros(s, self.max_pages_per_req, device=d),
            self._zeros(s, device=d), *self._warm_sampling(s, d),
        )
        steps_mod.pull_host(out[3])

    def _warm_vf(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, k, dt, m = key
        d = self._mesh_device(m)
        out = exe(
            self.paged_cache(dt, m), self._zeros(s, k + 1, device=d),
            self._zeros(s, device=d),
            self._zeros(s, self.max_pages_per_req, device=d),
            self._zeros(s, device=d), *self._warm_sampling(s, d),
        )
        steps_mod.pull_host(out[4])

    def _warm_dr(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, k, dt, m = key
        d = self._mesh_device(m)
        drafts, _, _, _ = exe(
            self.draft_cache(s, dt, m), self._zeros(s, 1, device=d),
            self._zeros(s, device=d),
            self._zeros(s, dtype=torch.bool, device=d),
            *self._warm_sampling(s, d),
        )
        steps_mod.pull_host(drafts)

    def _warm_drp(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, cb, dt, m = key
        d = self._mesh_device(m)
        out = exe(
            self.draft_cache(s, dt, m), self._zeros(s, cb, device=d),
            self._zeros(s, device=d), self._zeros(s, device=d),
            *self._warm_sampling(s, d),
        )
        steps_mod.pull_host(out[3])

    def _warm_mg(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        """Every index names the null page, so the scatter writes only that
        reserved page."""
        _, op, dt, m = key
        d = self._mesh_device(m)
        cache = self.paged_cache(dt, m)
        idx = self._zeros(self.max_pages_per_req, device=d)
        if op == "gather":
            exe(cache, idx)
        else:
            exe(cache, idx, *(
                torch.zeros(shape, dtype=dt, device=d) for shape, dt in
                steps_mod.page_block(cache, self.max_pages_per_req)))
        steps_mod.pull_host(idx)  # the call has run

    def _warm_lanes(self, kind: str, slots: int, ctx: _WarmCtx) -> None:
        """Registry-driven warmup (DESIGN.md §12): every enabled lane spec,
        every key in its fan-out, built and dummy-run."""
        for spec in LANES.for_engine(kind):
            if spec.enabled is not None and not getattr(self, spec.enabled)(ctx):
                continue
            pins = {"slots": slots} if "slots" in spec.axis_names else {}
            for key in spec.fanout(self, **pins):
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
    def _mesh_arg(self, mesh: str | None) -> str:
        """The batcher's decode mesh: canonical, warmed, and one the port
        runs (every warmed mesh is checked first)."""
        warm = self._warm_meshes()
        m0 = shd.mesh_name(*shd.parse_slice_name(mesh or self.ecfg.mesh))
        if m0 not in warm:
            raise ValueError(
                f"mesh={m0!r} is not in the warmed set {warm}; add it to "
                f"EngineConfig.mesh/meshes."
            )
        self._check_meshes()
        return m0

    def _disagg_plan(self, disagg, m0: str,
                     use_spec: bool) -> shd.DisaggPlan | None:
        """``paged_continuous(disagg=...)`` resolved and validated as the
        JAX package does (DESIGN.md §17)."""
        if not disagg:
            return None
        if isinstance(disagg, shd.DisaggPlan):
            dg = disagg
        elif isinstance(disagg, str):
            dg = shd.DisaggPlan(prefill=disagg, decode=m0)
        else:  # True: the devices right after the decode slice's
            dp, mp, off = shd.parse_slice_name(m0)
            dg = shd.DisaggPlan(
                prefill=shd.mesh_name(1, mp, off + dp * mp), decode=m0
            )
        warm = self._warm_meshes()
        if dg.decode != m0:
            raise ValueError(
                f"DisaggPlan.decode={dg.decode!r} must equal the active "
                f"mesh {m0!r}: the decode slice anchors the page pool "
                f"and the batcher's cache binding."
            )
        if dg.prefill not in warm:
            raise ValueError(
                f"disagg prefill slice {dg.prefill!r} is not in the warmed "
                f"set {warm}; add it to EngineConfig.meshes so its lanes "
                f"are warmed."
            )
        if use_spec:
            raise ValueError(
                "disaggregated prefill/decode does not compose with "
                "speculative decoding yet: the draft cache is dense "
                "(no page migration path); pass spec_decode=False."
            )
        if not self._supports_chunked_prefill():
            raise ValueError(
                "disaggregated prefill/decode needs the chunked prefill "
                "lane (EngineConfig.prefill_chunk > 0): without it prompts "
                "are forced through the decode lane and there is nothing "
                "to pin to a prefill slice."
            )
        return dg

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
        mesh: str | None = None,
        disagg: "bool | str | shd.DisaggPlan | None" = None,
    ) -> PagedContinuousBatcher:
        """Cold path: build the page pool + prefix cache, warm every enabled
        paged lane key through the registry — every warmed page dtype and
        mesh, and with speculation every k bucket and draft dtype — and
        return a paged batcher (DESIGN.md §9-§12, §16). The batcher's
        per-slot keys come from a numpy generator seeded with ``seed``;
        ``async_steps`` pipelines its steps (``async_depth`` issued steps at
        most, DESIGN.md §13) over the same warmed keys. ``kv_dtype`` /
        ``draft_kv_dtype`` / ``mesh`` override the configured pool dtype,
        draft dtype and mesh and must be in the warmed sets;
        ``spec_decode`` overrides ``spec_k > 0``. A stack with a mamba slot
        raises at once: its state is per row, not pageable.

        ``disagg`` opts into disaggregated prefill/decode (DESIGN.md §17):
        a prefill slice name (``"1x1@1"``), a ``DisaggPlan`` whose decode
        slice is the active mesh, or ``True`` for the slice on the device
        right after the decode slice's. Both slices must be warmed meshes;
        the prefill lanes then run on the prefill slice's own pool and a
        prompt's pages migrate to the decode pool at its PREFILL -> DECODE
        flip (the ``mg`` targets); ``set_disagg`` splits and collapses
        mid-stream as a rebind."""
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
        use_spec = (
            (ecfg.spec_k > 0 if spec_decode is None else spec_decode)
            and self._supports_spec_decode()
        )
        m0 = self._mesh_arg(mesh)
        dg = self._disagg_plan(disagg, m0, use_spec)
        ddt = draft_kv_dtype or ecfg.draft_kv_dtype
        if ddt not in self._warm_draft_kv_dtypes():
            raise ValueError(
                f"draft_kv_dtype={ddt!r} is not in the warmed set "
                f"{self._warm_draft_kv_dtypes()}; add it to EngineConfig."
                f"draft_kv_dtype/draft_kv_dtypes."
            )
        self._check_kernels()
        pool = PagePool(
            self.pool_pages, ecfg.page_size, kv_dtype=dt,
            telemetry=self.telemetry, shards=self.pool_shards,
        )
        # the prefill slice's own pool, of the same geometry: the two share
        # null-page ids, so migration's index padding fits both; the decode
        # pool stays the id authority (the prefix trie roots there)
        pf_pool = None if dg is None else PagePool(
            self.pool_pages, ecfg.page_size, kv_dtype=dt,
            telemetry=self.telemetry, shards=self.pool_shards,
        )
        # a new batcher starts from empty pools and draft caches, as a
        # fresh engine's; a batcher resident there is parked, not wiped
        owner = self._new_owner()
        cells = [m0] if dg is None else [m0, dg.prefill]
        owner.banks = [
            self._reset_storage(("paged", dt, m), self.paged_cache(dt, m))
            for m in cells
        ]
        for bank in owner.banks:
            bank.seat(owner)
        if use_spec:
            self._reset_drafts(s, ddt, m0, owner)
        ctx = _WarmCtx(spec=use_spec, disagg=dg is not None)
        self._warm_lanes("paged", s, ctx)
        # The shared mesh binding: "mesh" routes the decode-group lanes and
        # never moves while disaggregated; "prefill" (only with a plan)
        # routes the prefill-group lanes and flips between the prefill
        # slice and the decode mesh (the set_disagg rebind).
        mb = {"mesh": m0}
        if dg is not None:
            mb["prefill"] = dg.prefill

        def dispatch(pages_bucket: int) -> Callable:
            return self._decode.dispatch(
                lanes_mod.CBP.key(s, pages_bucket, dt, mb["mesh"]))

        prefill_dispatch = None
        if self._supports_chunked_prefill():

            def prefill_dispatch(chunk_bucket: int) -> Callable:
                # PF is a prefill-group lane (LaneSpec.slice): under a live
                # split it routes to the prefill slice binding
                return self._decode.dispatch(lanes_mod.PF.key(
                    s, chunk_bucket, dt, mb.get("prefill", mb["mesh"])))

        draft_dispatch = verify_dispatch = draft_prefill_dispatch = None
        if use_spec:
            draft_dispatch, verify_dispatch, draft_prefill_dispatch = (
                self._spec_dispatchers(
                    s, ddt, mb,
                    lambda k: lanes_mod.VF.key(s, k, dt, mb["mesh"]), owner,
                )
            )
        mesh_ctl = self._make_mesh_ctl(
            mb, owner,
            lambda m: (("paged", dt, m), self.paged_cache(dt, m)),
            lambda m: (("draft", s, ddt, m), self.draft_cache(s, ddt, m)),
            lambda pages_bucket: lanes_mod.CBP.key(
                s, pages_bucket, dt, mb["mesh"]),
        )
        # pre-bind the hot slot to the smallest bucket (already warmed)
        self._decode.dispatch(lanes_mod.CBP.key(s, 1, dt, m0))
        transport = disagg_ctl = None
        if dg is not None:
            transport = self._transport(dt, m0, dg.prefill)

            def disagg_ctl(on: bool) -> str:
                target = dg.prefill if on else m0
                if mb["prefill"] != target:
                    mb["prefill"] = target
                    self.telemetry.registry.inc("disagg_rebinds_total")
                    rec = self.telemetry.trace_or_none()
                    if rec is not None:
                        rec.emit("disagg_rebind", "dispatcher",
                                 args={"prefill": target, "on": on})
                return target

        self.mark_warm_boundary()
        return PagedContinuousBatcher(
            dispatch_fn=dispatch,
            pool=pool,
            prefix_cache=PrefixCache(pool),
            cache=self.paged_cache(dt, m0),
            num_slots=s,
            max_pages_per_req=self.max_pages_per_req,
            device=self._mesh_device(m0),
            cache_copy=models.copy_cache_pages,
            seed=seed,
            prefill_dispatch=prefill_dispatch,
            prefill_chunk=ecfg.prefill_chunk,
            token_budget=ecfg.token_budget,
            telemetry=self.telemetry,
            draft_dispatch=draft_dispatch,
            verify_dispatch=verify_dispatch,
            draft_prefill_dispatch=draft_prefill_dispatch,
            draft_cache=self.draft_cache(s, ddt, m0) if use_spec else None,
            spec_k=ecfg.spec_k if use_spec else 0,
            async_steps=async_steps,
            async_depth=async_depth,
            storage=owner,
            mesh=m0,
            mesh_ctl=mesh_ctl,
            pf_pool=pf_pool,
            pf_cache=None if dg is None else self.paged_cache(dt, dg.prefill),
            pf_device=None if dg is None else self._mesh_device(dg.prefill),
            transport=transport,
            disagg_ctl=disagg_ctl,
            disagg=dg is not None,
        )

    def _transport(self, kv_dtype: str, decode: str,
                   prefill: str) -> Callable:
        """The page transport between a split's two pools (DESIGN.md §17):
        ``transport(src_cache, dst_cache, src_ids, dst_ids, to_prefill)``
        gathers the pages on the source slice's ``mg`` target, moves the
        block to the destination's device (a device-local copy when both
        slices name one card) and scatters it on the destination's. The
        page ids move separately (``kvcache.migrate_pages``). Indices past
        ``len(ids)`` name the null page, reserved on both ends, so a short
        migration runs the same targets."""
        mg = {
            (op, m): self._decode.dispatch(lanes_mod.MG.key(op, kv_dtype, m))
            for op in self._mg_ops()
            for m in (decode, prefill)
        }
        b = self.max_pages_per_req

        def idx(ids, step, mesh: str) -> torch.Tensor:
            host = np.zeros(b, np.int32)  # the null page
            host[: len(ids)] = ids
            ins = _static_inputs(step)
            return _upload(host, self._mesh_device(mesh), ins[0])

        def transport(src_cache, dst_cache, src_ids, dst_ids,
                      to_prefill: bool = False) -> None:
            src_m, dst_m = ((decode, prefill) if to_prefill
                            else (prefill, decode))
            gather, scatter = mg["gather", src_m], mg["scatter", dst_m]
            block = gather(src_cache, idx(src_ids, gather, src_m))
            dev = self._mesh_device(dst_m)
            scatter(dst_cache, idx(dst_ids, scatter, dst_m),
                    *(t.to(dev) for t in block))

        return transport

    def _spec_dispatchers(self, slots: int, draft_kv_dtype: str,
                          mesh_bind: dict,
                          verify_key: Callable[[int], tuple],
                          owner: _Owner):
        """The speculative lanes' dispatch closures over warmed keys: the
        draft lanes pin the draft dtype, read the batcher's live mesh
        binding (so a topology flip re-routes them on their next dispatch)
        and make ``owner``'s draft state the resident one (the batcher
        calls its draft target right after); ``verify_key(k)`` is the
        engine's verify key (``vf`` over its pool dtype, or ``vfd``)."""
        s, ddt, mb = slots, draft_kv_dtype, mesh_bind

        def draft_dispatch(k: int) -> Callable:
            self._banks["draft", s, ddt, mb["mesh"]].claim(owner)
            return self._decode.dispatch(
                lanes_mod.DR.key(s, k, ddt, mb["mesh"]))

        def verify_dispatch(k: int) -> Callable:
            return self._decode.dispatch(verify_key(k))

        def draft_prefill_dispatch(chunk_bucket: int) -> Callable:
            # DRP is a prefill-group lane; with no split it is the shared mesh
            m = mb.get("prefill", mb["mesh"])
            self._banks["draft", s, ddt, m].claim(owner)
            return self._decode.dispatch(
                lanes_mod.DRP.key(s, chunk_bucket, ddt, m))

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
        mesh: str | None = None,
    ) -> ContinuousBatcher:
        """Cold path: warm every enabled dense lane key through the registry
        — ``cb``, ``pfd`` per chunk bucket, and with speculation ``vfd``,
        ``dr`` and ``drp`` per k bucket and chunk bucket, each on every
        warmed mesh — over the engine's dense caches of ``slots`` rows, and
        return a dense batcher on ``mesh`` (DESIGN.md §4/§10/§11/§16).
        Joins, leaves, greedy/sample flips, chunk sizes, draft depths and
        mesh flips are then data or rebinds over warmed keys. The batcher's
        per-slot keys come from a numpy generator seeded with ``seed``;
        ``async_steps``/``async_depth`` as ``paged_continuous``;
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
        m0 = self._mesh_arg(mesh)
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
        cache = self.dense_cache(s, m0)
        owner.banks = [self._reset_storage(("dense", s, m0), cache)]
        owner.banks[0].seat(owner)
        if use_spec:
            self._reset_drafts(s, ddt, m0, owner)
        ctx = _WarmCtx(spec=use_spec)
        self._warm_lanes("dense", s, ctx)
        self.zero_cache(cache)
        mb = {"mesh": m0}
        key = lanes_mod.CB.key(s, m0)
        step = self._decode.dispatch(key)  # binds the hot slot (warmed)
        self._warm_cb(key, step, ctx)  # on the zeroed cache, see above

        def step_dispatch() -> Callable:
            return self._decode.dispatch(lanes_mod.CB.key(s, mb["mesh"]))

        prefill_dispatch = None
        if self._supports_chunked_prefill():

            def prefill_dispatch(chunk_bucket: int) -> Callable:
                return self._decode.dispatch(
                    lanes_mod.PFD.key(s, chunk_bucket, mb["mesh"])
                )

        draft_dispatch = verify_dispatch = draft_prefill_dispatch = None
        if use_spec:
            draft_dispatch, verify_dispatch, draft_prefill_dispatch = (
                self._spec_dispatchers(
                    s, ddt, mb, lambda k: lanes_mod.VFD.key(s, k, mb["mesh"]),
                    owner,
                )
            )
        mesh_ctl = self._make_mesh_ctl(
            mb, owner,
            lambda m: (("dense", s, m), self.dense_cache(s, m)),
            lambda m: (("draft", s, ddt, m), self.draft_cache(s, ddt, m)),
            lambda: lanes_mod.CB.key(s, mb["mesh"]),
        )
        self.mark_warm_boundary()
        return ContinuousBatcher(
            step=step,
            num_slots=s,
            max_len=self.ecfg.max_len,
            cache=cache,
            device=self._mesh_device(m0),
            seed=seed,
            prefill_dispatch=prefill_dispatch,
            prefill_chunk=self.ecfg.prefill_chunk,
            token_budget=self.ecfg.token_budget,
            telemetry=self.telemetry,
            draft_dispatch=draft_dispatch,
            verify_dispatch=verify_dispatch,
            draft_prefill_dispatch=draft_prefill_dispatch,
            draft_cache=self.draft_cache(s, ddt, m0) if use_spec else None,
            spec_k=self.ecfg.spec_k if use_spec else 0,
            async_steps=async_steps,
            async_depth=async_depth,
            storage=owner,
            mesh=m0,
            mesh_ctl=mesh_ctl,
            step_dispatch=step_dispatch,
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
    mesh: str | None = None,
) -> dict:
    """Drive a request stream through the dense continuous engine (on
    ``mesh``, a warmed one); return a report with the JAX package's keys.

    The acceptance metric is ``compiles_after_warmup`` (on the card:
    captures after warmup): 0 for any mix of greedy and sampled requests,
    prompt lengths and draft depths once ``continuous`` has warmed.
    ``async_steps`` pipelines host scheduling against device execution
    (DESIGN.md §13; ``async_depth`` caps the in-flight steps); the token
    streams are the same either way."""
    cb = eng.continuous(slots=slots, seed=seed, async_steps=async_steps,
                        async_depth=async_depth, mesh=mesh)  # warmup first...
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
        mesh=cb.mesh,
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
    mesh: str | None = None,
    disagg: "bool | str | shd.DisaggPlan | None" = None,
) -> dict:
    """Drive a request stream through the paged KV engine; return a report.

    The acceptance contract: zero builds after warmup (every bucket of
    every lane was warmed), and sharing lets peak *logical* tokens exceed
    the pool's physical capacity on shared-prefix traffic. ``kv_dtype``
    overrides the configured pool dtype (it must be in the warmed set).
    With ``EngineConfig.spec_k > 0`` the report's ``spec`` block carries
    drafted/accepted tokens, the acceptance rate and k-bucket crossings.
    ``async_steps``/``async_depth`` as ``run_continuous_stream``. ``mesh``
    and ``disagg`` as ``Engine.paged_continuous``: a disaggregated run's
    report counts its page migrations (``migrations``, ``migrated_pages``)
    and the engine's ``disagg_rebinds``; its greedy tokens equal the shared
    run's.
    """
    cb = eng.paged_continuous(slots=slots, seed=seed, kv_dtype=kv_dtype,
                              async_steps=async_steps,
                              async_depth=async_depth, mesh=mesh,
                              disagg=disagg)
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
        mesh=cb.mesh,
        device=str(eng.device),
        attn_impl=eng.ecfg.attn_impl,
        cuda_graphs=eng.graphs,
        slots=cb.num_slots,
        steps=cb.stats.steps,
        occupancy=round(cb.stats.occupancy, 4),
        page_size=cb.pool.page_size,
        kv_dtype=cb.pool.kv_dtype,
        pool_shards=cb.pool.shards,
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
        disagg=cb.disagg,
        migrations=cb.stats.migrations,
        migrated_pages=cb.stats.migrated_pages,
        disagg_rebinds=int(
            eng.telemetry.registry.value("disagg_rebinds_total")
        ),
        mesh_rebinds=int(eng.telemetry.registry.value("mesh_rebinds_total")),
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
