"""Serving engine on the unified dispatch core (counterpart of
``repro.runtime.serve``: the per-burst engine and the paged continuous
path).

The HFT analogy (DESIGN.md §2/§4): the *hot path* is the token loop — it
never builds a step or branches on mode. The *cold path* is the scheduler: it
admits requests, picks the branch target in the ``Dispatcher``'s table,
warms it, and only then lets the hot loop run.

A **branch target** for a dispatch key is the step callable specialised on
the key's static shapes and page dtype — slots, ``pages_bucket`` and
``kv_dtype`` for the ``cbp`` decode lane, slots, ``chunk_bucket`` and
``kv_dtype`` for the ``pf`` prefill lane, slots, ``k_bucket`` and
``kv_dtype`` for the ``vf`` verify lane, slots, ``k_bucket`` /
``chunk_bucket`` and ``draft_kv_dtype`` for the ``dr``/``drp`` draft lanes —
with the attention implementation (``EngineConfig.attn_impl``) baked in when
it is built. **Warm** means build plus one dummy run. Every key in every
enabled lane's fan-out is warmed before the stream starts, so
``compiles_after_warmup`` (builds after the warm boundary) stays 0 and a
bucket, k or dtype crossing is a rebind. Capturing the targets as CUDA
graphs is later work.

The **per-burst engine** is the paper's construct in its plain form: a burst
of requests shares one sampling mode, ``set_mode`` (the cold path) buckets
the batch, dispatches the ``("burst", bucket, mode)`` target — building it
on first sight — rebinds the hot slot and warms it with a dummy run, and
``decode_loop`` (the hot path) calls the slot directly, step after step,
chaining tokens and the position on the device (kernel B5 reads the
position there) and pulling the tokens once at the end.
``run_burst_stream`` drives a request stream through it; its builds after
the stream starts are the keys it first meets, the baseline cost the
continuous engines remove. It serves the SSM family too: a mamba slot's
dense cache is its recurrent conv window and state, stepped in place. The
paged path is attention-only.

The engine runs on the card by default (``device="cuda"``) and raises when
no GPU is present unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import ArchConfig
from repro_torch.core import DispatchError, DispatchPolicy, Dispatcher
from repro_torch.core import bucket_multiple
from repro_torch.core import lanes as lanes_mod
from repro_torch.core.lanes import LANES
from repro_torch.core.telemetry import Telemetry
from repro_torch.runtime import steps as steps_mod
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


@dataclass
class _WarmCtx:
    """State threaded through one warmup pass: the pooled caches the dummy
    runs write into, one per warmed page dtype (their writes land in the
    null page only), the draft caches per draft dtype, the batcher's
    speculation opt-in, and a throwaway generator, so warmup consumes none
    of the batcher's draws."""

    paged_caches: dict  # kv_dtype -> pooled cache
    generator: torch.Generator
    spec: bool = False
    draft_caches: dict = field(default_factory=dict)  # draft dtype -> cache


class Engine:
    """Single-device engine: the per-burst engine and the paged serving
    lanes."""

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
        if ecfg.attn_impl not in models.ATTN_IMPLS:
            raise ValueError(
                f"attn_impl must be one of {models.ATTN_IMPLS}, got "
                f"{ecfg.attn_impl!r}"
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

    def _guarded(
        self, step: Callable, shapes: dict, cache_dtype: torch.dtype,
        params: dict | None = None,
    ) -> Callable:
        """Bind ``step`` to the key's static shapes and cache dtype: a call
        with other shapes, another cache dtype, or off the engine's device
        is a dispatch bug and raises (the aval guard of a compiled
        executable). ``params`` defaults to the target's weights."""
        params = self.params if params is None else params
        device = self.device

        def target(cache, *rows):
            # the K/V rows or pages, or a mamba slot's conv window
            got = cache[0]["k" if "k" in cache[0] else "conv"].dtype
            if got != cache_dtype:
                raise ValueError(
                    f"cache: expected {cache_dtype} K/V, got {got}"
                )
            for (name, want), t in zip(shapes.items(), rows):
                if tuple(t.shape) != want or t.device != device:
                    raise ValueError(
                        f"{name}: expected {want} on {device}, got "
                        f"{tuple(t.shape)} on {t.device}"
                    )
            return step(params, cache, *rows)

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
        mode baked in (the per-burst engine, DESIGN.md §2)."""
        step = steps_mod.make_sampling_decode_fn(
            self.cfg, mode=mode, temperature=self.ecfg.temperature,
            attn_impl=self.ecfg.attn_impl,
        )
        return self._guarded(
            step, {"tok": (batch, 1), "pos": ()}, dtype_of(self.cfg)
        )

    def _build_paged_slot_decode(
        self, slots: int, pages_bucket: int, kv_dtype: str
    ) -> Callable:
        """Branch target for ``("cbp", slots, pages_bucket, kv_dtype)``:
        capacity is a semi-static condition (DESIGN.md §9) — the block
        table's width is part of the target's shapes, and outgrowing the
        bucket re-dispatches on the cold path; the page dtype is another
        (DESIGN.md §12), so model-dtype and int8 pools are two targets."""
        step = steps_mod.make_paged_slot_decode_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl
        )
        return self._guarded(step, {
            "tok": (slots, 1), "pos": (slots,),
            "block_tables": (slots, pages_bucket), "active": (slots,),
            "temps": (slots,), "greedy": (slots,),
        }, self._kv_torch_dtype(kv_dtype, self.cfg))

    def _build_paged_prefill(
        self, slots: int, chunk_bucket: int, kv_dtype: str
    ) -> Callable:
        """Branch target for ``("pf", slots, chunk_bucket, kv_dtype)``:
        batched chunked prefill (DESIGN.md §10). The chunk width is part of
        the shapes; the block table is pinned at the per-request page cap."""
        step = steps_mod.make_paged_prefill_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl
        )
        return self._guarded(step, {
            "tok": (slots, chunk_bucket), "start": (slots,),
            "block_tables": (slots, self.max_pages_per_req),
            "length": (slots,), "temps": (slots,), "greedy": (slots,),
        }, self._kv_torch_dtype(kv_dtype, self.cfg))

    def _build_paged_verify(self, slots: int, k: int, kv_dtype: str) -> Callable:
        """Branch target for ``("vf", slots, k, kv_dtype)``: the target
        scores all K+1 window positions in one pass through the paged chunk
        path (DESIGN.md §11). The window width k+1 is part of the shapes;
        the block table is pinned at the per-request page cap."""
        step = steps_mod.make_paged_verify_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl
        )
        return self._guarded(step, {
            "tok": (slots, k + 1), "start": (slots,),
            "block_tables": (slots, self.max_pages_per_req),
            "length": (slots,), "temps": (slots,), "greedy": (slots,),
        }, self._kv_torch_dtype(kv_dtype, self.cfg))

    def _build_draft(self, slots: int, k: int, draft_kv_dtype: str) -> Callable:
        """Branch target for ``("dr", slots, k, draft_kv_dtype)``: K draft
        decode steps looped inside one target (DESIGN.md §11), so depth
        variation re-dispatches on the cold path; the draft cache's dtype is
        its own coordinate (DESIGN.md §16)."""
        step = steps_mod.make_draft_fn(self.draft_cfg, k=k)
        return self._guarded(step, {
            "tok": (slots, 1), "pos": (slots,), "active": (slots,),
        }, self._kv_torch_dtype(draft_kv_dtype, self.draft_cfg),
            params=self.draft_params)

    def _build_draft_prefill(
        self, slots: int, chunk_bucket: int, draft_kv_dtype: str
    ) -> Callable:
        """Branch target for ``("drp", slots, chunk_bucket,
        draft_kv_dtype)``: the draft's prompt mirror — chunked dense
        ingestion over the draft view, so its cache tracks the prompts."""
        step = steps_mod.make_slot_prefill_fn(self.draft_cfg)
        return self._guarded(step, {
            "tok": (slots, chunk_bucket), "start": (slots,),
            "length": (slots,), "temps": (slots,), "greedy": (slots,),
        }, self._kv_torch_dtype(draft_kv_dtype, self.draft_cfg),
            params=self.draft_params)

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

    def _supports_chunked_prefill(self, ctx: Any = None) -> bool:
        """The ``pf`` lane's gate (``LaneSpec.enabled``): a chunk size set."""
        return self.ecfg.prefill_chunk > 0

    def _supports_spec_decode(self) -> bool:
        """Speculation needs a draft depth (the port's stacks are
        attention-only, which the verify lane's chunk path requires)."""
        return self.ecfg.spec_k > 0

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
        )

    def _warm_cbp(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, pb, dt = key
        out = exe(
            ctx.paged_caches[dt], self._zeros(s, 1), self._zeros(s),
            self._zeros(s, pb), self._zeros(s, dtype=torch.bool),
            *self._warm_sampling(s), ctx.generator,
        )
        steps_mod.pull_host(out[4])

    def _warm_pf(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, cb, dt = key
        nxt, _ = exe(
            ctx.paged_caches[dt], self._zeros(s, cb), self._zeros(s),
            self._zeros(s, self.max_pages_per_req), self._zeros(s),
            *self._warm_sampling(s), ctx.generator,
        )
        steps_mod.pull_host(nxt)

    def _warm_vf(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, k, dt = key
        out = exe(
            ctx.paged_caches[dt], self._zeros(s, k + 1), self._zeros(s),
            self._zeros(s, self.max_pages_per_req), self._zeros(s),
            *self._warm_sampling(s), ctx.generator,
        )
        steps_mod.pull_host(out[3])

    def _draft_warm_cache(self, ctx: _WarmCtx, s: int, dt: str) -> list:
        """The draft cache of dtype ``dt``, created on its first warm."""
        if dt not in ctx.draft_caches:
            ctx.draft_caches[dt] = models.init_cache(
                self.draft_cfg, s, self.ecfg.max_len, dt, device=self.device
            )
        return ctx.draft_caches[dt]

    def _warm_dr(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, k, dt = key
        drafts, _, _ = exe(
            self._draft_warm_cache(ctx, s, dt), self._zeros(s, 1),
            self._zeros(s), self._zeros(s, dtype=torch.bool),
        )
        steps_mod.pull_host(drafts)

    def _warm_drp(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, cb, dt = key
        nxt, _ = exe(
            self._draft_warm_cache(ctx, s, dt), self._zeros(s, cb),
            self._zeros(s), self._zeros(s), *self._warm_sampling(s),
            ctx.generator,
        )
        steps_mod.pull_host(nxt)

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
        """Snapshot the dispatcher's build/rebind counters and roll the
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
        """Dispatcher builds since the last ``mark_warm_boundary``."""
        base = (self._warm_marks or {}).get("compiles", 0)
        return self._decode.stats.misses - base

    @property
    def post_warmup_rebinds(self) -> int:
        base = (self._warm_marks or {}).get("rebinds", 0)
        return self._decode.stats.rebinds - base

    # ------------------------------------------------------ per-burst engine
    def set_mode(self, *, batch: int, sampling: int = GREEDY) -> dict:
        """Cold path: bucket the batch, build-or-fetch the burst target,
        rebind the hot slot, and warm it with one dummy run on a fresh
        cache (dummy-order warming, paper §4.3)."""
        t0 = time.perf_counter()
        bucket = bucket_multiple(
            batch, self.ecfg.batch_quantum, self.ecfg.max_batch
        )
        key = lanes_mod.BURST.key(bucket, sampling)
        exe = self._decode.dispatch(key)
        self._current = exe  # <- the jmp patch (engine-side mirror)
        cache = models.init_cache(
            self.cfg, bucket, self.ecfg.max_len, device=self.device
        )
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        tok, _ = exe(cache, self._zeros(bucket, 1), self._zeros(), gen)
        steps_mod.pull_host(tok)
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
        generator: torch.Generator | None = None,
        on_step: Callable[[int, torch.Tensor], None] | None = None,
    ) -> tuple[np.ndarray, list]:
        """The latency-critical loop: direct calls of the hot slot only.

        ``first_token`` i32[B,1] (B = the bucket ``set_mode`` chose);
        ``cache`` a dense cache of ``max_len`` rows holding positions before
        ``start_pos``. Each step's token and position stay on the device and
        feed the next step; the tokens are pulled once, at the end, as
        ``[B, num_tokens]``. Sampled bursts draw from ``generator`` (a fresh
        one seeded 0 if None). ``on_step(i, tok)`` observes each step's
        device output as it is issued — e.g. to timestamp the first token
        without serialising the rest of the loop."""
        exe = self._current
        if exe is None:
            raise DispatchError("set_mode() before decode_loop() (cold path)")
        tok = torch.as_tensor(first_token, dtype=torch.int32).to(self.device)
        batch = int(tok.shape[0])
        if num_tokens <= 0:
            return np.zeros((batch, 0), np.int32), cache
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        # Burst/continuous report parity (DESIGN.md §14): burst steps feed
        # the same registry families the batcher lanes do, under the
        # "burst" lane label.
        if self._burst_calls is None:
            reg = self.telemetry.registry
            self._burst_calls = reg.counter("lane_calls_total", lane="burst")
            self._burst_hist = reg.histogram("lane_step_ms", lane="burst")
        rec = self.telemetry.trace_or_none()
        pos = torch.tensor(start_pos, dtype=torch.int32, device=self.device)
        out = []
        for i in range(num_tokens):
            t0_ns = time.perf_counter_ns()
            nxt, cache = exe(cache, tok, pos, generator)
            dt_ns = time.perf_counter_ns() - t0_ns
            self._burst_calls.inc()
            self._burst_hist.observe(dt_ns / 1e6)
            if rec is not None:
                rec.emit(
                    "lane_step", "lane:burst", ph="X",
                    ts_ns=t0_ns, dur_ns=dt_ns, args={"step": i},
                )
            out.append(nxt)
            if on_step is not None:
                on_step(i, nxt)
            tok = nxt[:, None]
            pos = pos + 1
            self.stats["hot_calls"] += 1
        self.stats["tokens"] += num_tokens * batch
        toks, _ = steps_mod.pull_host(torch.stack(out, dim=1), rec)
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
    ) -> PagedContinuousBatcher:
        """Cold path: build the page pool + prefix cache, warm every enabled
        paged lane key through the registry — every warmed page dtype, and
        with speculation every k bucket and draft dtype — and return a paged
        batcher (DESIGN.md §9-§12). Sampled rows draw from a generator
        seeded with ``seed``. ``kv_dtype`` / ``draft_kv_dtype`` override the
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
        pool = PagePool(
            self.pool_pages, ecfg.page_size, kv_dtype=dt,
            telemetry=self.telemetry,
        )
        warm_gen = torch.Generator(device=self.device)
        warm_gen.manual_seed(seed)
        ctx = _WarmCtx(
            paged_caches={
                d: models.init_paged_cache(
                    self.cfg, self.pool_physical_pages, ecfg.page_size, d,
                    device=self.device,
                )
                for d in self._warm_kv_dtypes()
            },
            generator=warm_gen,
            spec=use_spec,
        )
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
                self._spec_dispatchers(s, dt, ddt)
            )

        # pre-bind the hot slot to the smallest bucket (already warmed)
        self._decode.dispatch(lanes_mod.CBP.key(s, 1, dt))
        self.mark_warm_boundary()
        return PagedContinuousBatcher(
            dispatch_fn=dispatch,
            pool=pool,
            prefix_cache=PrefixCache(pool),
            cache=ctx.paged_caches[dt],
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
            draft_cache=ctx.draft_caches.get(ddt) if use_spec else None,
            spec_k=ecfg.spec_k if use_spec else 0,
        )

    def _spec_dispatchers(self, slots: int, kv_dtype: str, draft_kv_dtype: str):
        """The speculative lanes' dispatch closures over warmed keys: the
        verify lane pins the pool dtype, the draft lanes the draft dtype."""
        s = slots

        def draft_dispatch(k: int) -> Callable:
            return self._decode.dispatch(lanes_mod.DR.key(s, k, draft_kv_dtype))

        def verify_dispatch(k: int) -> Callable:
            return self._decode.dispatch(lanes_mod.VF.key(s, k, kv_dtype))

        def draft_prefill_dispatch(chunk_bucket: int) -> Callable:
            return self._decode.dispatch(
                lanes_mod.DRP.key(s, chunk_bucket, draft_kv_dtype)
            )

        return draft_dispatch, verify_dispatch, draft_prefill_dispatch


# ----------------------------------------------------------- stream runners
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
    ``first_token``. Sampled bursts draw from one generator seeded ``seed``.
    """
    clock = clock or Clock()
    q = RequestQueue(requests)
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(seed)
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
            cache = models.init_cache(
                eng.cfg, b, eng.ecfg.max_len, device=eng.device
            )
            first = torch.zeros((b, 1), dtype=torch.int32)
            for i, r in enumerate(chunk):
                first[i, 0] = r.first_token
                r.t_admit = clock.now()
            first_t: dict = {}

            def note_first(i, tok, _first_t=first_t):
                if i == 0:  # TTFT: when the first step's output exists
                    steps_mod.pull_host(tok)
                    _first_t["t"] = clock.now()

            toks, _ = eng.decode_loop(  # hot path
                cache, first.to(eng.device), 0,
                max(r.new_tokens for r in chunk), generator=gen,
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
) -> dict:
    """Drive a request stream through the paged KV engine; return a report.

    The acceptance contract: zero builds after warmup (every bucket of
    every lane was warmed), and sharing lets peak *logical* tokens exceed
    the pool's physical capacity on shared-prefix traffic. ``kv_dtype``
    overrides the configured pool dtype (it must be in the warmed set).
    With ``EngineConfig.spec_k > 0`` the report's ``spec`` block carries
    drafted/accepted tokens, the acceptance rate and k-bucket crossings.
    """
    cb = eng.paged_continuous(slots=slots, seed=seed, kv_dtype=kv_dtype)
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
    report = latency_report(finished, batcher=cb)
    report.update(
        engine="paged",
        device=str(eng.device),
        attn_impl=eng.ecfg.attn_impl,
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
