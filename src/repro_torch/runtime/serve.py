"""Serving engine on the unified dispatch core (counterpart of
``repro.runtime.serve``, paged continuous path).

The HFT analogy (DESIGN.md §2/§4): the *hot path* is the token loop — it
never builds a step or branches on mode. The *cold path* is the scheduler: it
admits requests, picks the branch target in the ``Dispatcher``'s table,
warms it, and only then lets the hot loop run.

A **branch target** for a dispatch key is the step callable specialised on
the key's static shapes — slots and ``pages_bucket`` for the ``cbp`` decode
lane, slots and ``chunk_bucket`` for the ``pf`` prefill lane — with the
attention implementation (``EngineConfig.attn_impl``) baked in when it is
built. **Warm** means build plus one dummy run. Every key in every enabled
lane's fan-out is warmed before the stream starts, so
``compiles_after_warmup`` (builds after the warm boundary) stays 0 and a
bucket crossing is a rebind. Capturing the targets as CUDA graphs is later
work.

The engine runs on the card by default (``device="cuda"``) and raises when
no GPU is present unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch import models
from repro_torch.configs import ArchConfig
from repro_torch.core import Dispatcher
from repro_torch.core import lanes as lanes_mod
from repro_torch.core.lanes import LANES
from repro_torch.core.telemetry import Telemetry
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.kvcache import PagePool, PrefixCache, sharing_report
from repro_torch.runtime.scheduler import (
    CHUNK_BUCKET_MIN,
    Clock,
    PagedContinuousBatcher,
    Request,
    RequestQueue,
    latency_report,
)


@dataclass
class EngineConfig:
    max_len: int = 512
    max_batch: int = 64
    # Paged KV cache (DESIGN.md §9): page granularity and pool size
    # (allocatable pages, excluding the reserved null page). 0 pages means
    # "dense-equivalent": max_batch × max_len tokens worth of pages.
    page_size: int = 16
    num_pages: int = 0
    # Chunked prefill (DESIGN.md §10): the largest prompt chunk ingested per
    # step; 0 disables the chunked lane (prompts teacher-force token by
    # token). Chunk sizes come from the log-sized bucket set {8, ...,
    # prefill_chunk}, each a warmed ("pf", slots, chunk_bucket) key.
    prefill_chunk: int = 0
    # Attention implementation baked into every step (semi-static):
    # "kernel" (B1/B2; their plain versions on the CPU) or "plain".
    attn_impl: str = "kernel"


@dataclass
class _WarmCtx:
    """State threaded through one warmup pass: the pooled cache the dummy
    runs write into (their writes land in the null page only) and a
    throwaway generator, so warmup consumes none of the batcher's draws."""

    cache: Any
    generator: torch.Generator


class Engine:
    """Single-device engine over the paged serving lanes."""

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
        self.telemetry = telemetry or Telemetry()
        self._warm_marks: dict | None = None
        self._decode = Dispatcher(
            self._build,
            name=f"decode@{id(self):x}",
            recorder=self.telemetry.recorder,
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

    def _guarded(self, step: Callable, shapes: dict) -> Callable:
        """Bind ``step`` to the key's static shapes: a call with other
        shapes, or off the engine's device, is a dispatch bug and raises
        (the aval guard of a compiled executable)."""
        params, device = self.params, self.device

        def target(cache, *rows):
            for (name, want), t in zip(shapes.items(), rows):
                if tuple(t.shape) != want or t.device != device:
                    raise ValueError(
                        f"{name}: expected {want} on {device}, got "
                        f"{tuple(t.shape)} on {t.device}"
                    )
            return step(params, cache, *rows)

        return target

    def _build_paged_slot_decode(self, slots: int, pages_bucket: int) -> Callable:
        """Branch target for ``("cbp", slots, pages_bucket)``:
        capacity is a semi-static condition (DESIGN.md §9) — the block
        table's width is part of the target's shapes, and outgrowing the
        bucket re-dispatches on the cold path."""
        step = steps_mod.make_paged_slot_decode_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl
        )
        return self._guarded(step, {
            "tok": (slots, 1), "pos": (slots,),
            "block_tables": (slots, pages_bucket), "active": (slots,),
            "temps": (slots,), "greedy": (slots,),
        })

    def _build_paged_prefill(self, slots: int, chunk_bucket: int) -> Callable:
        """Branch target for ``("pf", slots, chunk_bucket)``:
        batched chunked prefill (DESIGN.md §10). The chunk width is part of
        the shapes; the block table is pinned at the per-request page cap."""
        step = steps_mod.make_paged_prefill_fn(
            self.cfg, attn_impl=self.ecfg.attn_impl
        )
        return self._guarded(step, {
            "tok": (slots, chunk_bucket), "start": (slots,),
            "block_tables": (slots, self.max_pages_per_req),
            "length": (slots,), "temps": (slots,), "greedy": (slots,),
        })

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

    def _pages_buckets(self) -> list[int]:
        """The log-sized capacity-bucket fan-out {1, 2, ..., page cap}."""
        out, pb = [], 1
        while True:
            out.append(pb)
            if pb >= self.max_pages_per_req:
                return out
            pb = min(pb * 2, self.max_pages_per_req)

    def _supports_chunked_prefill(self, ctx: Any = None) -> bool:
        """The ``pf`` lane's gate (``LaneSpec.enabled``): a chunk size set."""
        return self.ecfg.prefill_chunk > 0

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
        _, s, pb = key
        out = exe(
            ctx.cache, self._zeros(s, 1), self._zeros(s), self._zeros(s, pb),
            self._zeros(s, dtype=torch.bool), *self._warm_sampling(s),
            ctx.generator,
        )
        steps_mod.pull_host(out[4])

    def _warm_pf(self, key: tuple, exe: Callable, ctx: _WarmCtx) -> None:
        _, s, cb = key
        nxt, _ = exe(
            ctx.cache, self._zeros(s, cb), self._zeros(s),
            self._zeros(s, self.max_pages_per_req), self._zeros(s),
            *self._warm_sampling(s), ctx.generator,
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

    def paged_continuous(
        self, *, slots: int | None = None, seed: int = 0
    ) -> PagedContinuousBatcher:
        """Cold path: build the page pool + prefix cache, warm every paged
        lane key through the registry, and return a paged batcher
        (DESIGN.md §9/§10). Sampled rows draw from a generator seeded with
        ``seed``."""
        if self.cfg.input_kind != "tokens":
            raise ValueError(
                f"{self.cfg.name}: continuous batching feeds sampled ids "
                f"back as inputs and needs a token-input arch."
            )
        s = slots or self.ecfg.max_batch
        ecfg = self.ecfg
        pool = PagePool(
            self.pool_pages, ecfg.page_size, telemetry=self.telemetry
        )
        cache = models.init_paged_cache(
            self.cfg, self.pool_physical_pages, ecfg.page_size,
            device=self.device,
        )
        warm_gen = torch.Generator(device=self.device)
        warm_gen.manual_seed(seed)
        self._warm_lanes("paged", s, _WarmCtx(cache=cache, generator=warm_gen))

        def dispatch(pages_bucket: int) -> Callable:
            return self._decode.dispatch(lanes_mod.CBP.key(s, pages_bucket))

        prefill_dispatch = None
        if self._supports_chunked_prefill():

            def prefill_dispatch(chunk_bucket: int) -> Callable:
                return self._decode.dispatch(lanes_mod.PF.key(s, chunk_bucket))

        # pre-bind the hot slot to the smallest bucket (already warmed)
        self._decode.dispatch(lanes_mod.CBP.key(s, 1))
        self.mark_warm_boundary()
        return PagedContinuousBatcher(
            dispatch_fn=dispatch,
            pool=pool,
            prefix_cache=PrefixCache(pool),
            cache=cache,
            num_slots=s,
            max_pages_per_req=self.max_pages_per_req,
            device=self.device,
            cache_copy=models.copy_cache_pages,
            seed=seed,
            prefill_dispatch=prefill_dispatch,
            prefill_chunk=ecfg.prefill_chunk,
            telemetry=self.telemetry,
        )


# ------------------------------------------------------------ stream driver
def run_paged_stream(
    eng: Engine,
    requests: list[Request],
    *,
    slots: int | None = None,
    seed: int = 0,
    clock: Clock | None = None,
) -> dict:
    """Drive a request stream through the paged KV engine; return a report.

    The acceptance contract: zero builds after warmup (every bucket of
    every lane was warmed), and sharing lets peak *logical* tokens exceed
    the pool's physical capacity on shared-prefix traffic.
    """
    cb = eng.paged_continuous(slots=slots, seed=seed)  # warmup first
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
        cow_copies=cb.pool.stats.cow_copies,
        prefix_evictions=cb.pool.stats.prefix_evictions,
        unserved=len(requests) - len(finished),
        compiles_total=eng._decode.stats.misses,
        compiles_after_warmup=eng.post_warmup_compiles,
        rebinds=eng.post_warmup_rebinds,
    )
    return report
