"""Request scheduler + paged continuous batching (counterpart of
``repro.runtime.scheduler``, synchronous paged path).

* ``Request`` / ``RequestQueue`` / ``Clock`` and the traffic generators
  (``poisson_arrivals``, ``shared_prefix_arrivals``,
  ``attach_distinct_prompts``) are the JAX package's, unchanged.
* ``PagedContinuousBatcher`` — slot-based continuous batching against a
  paged KV pool (``runtime.kvcache``, DESIGN.md §9) with two lanes: ``cbp``
  (one token per decoding slot) and ``pf`` (batched chunked prefill,
  DESIGN.md §10). Block tables map positions onto pooled pages, prompts
  share full pages through the prefix cache, pool pressure evicts idle
  prefix pages and then preempts, and both lanes' bucket axes are
  semi-static dispatch keys: a crossing is a rebind on the cold path, never
  a build.

Left for later slices of the port: the async step pipeline, the
draft/verify lanes, disaggregation, the mesh axis, fault injection,
deadlines and the watchdog.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core import bucket_pow2
from repro_torch.core.telemetry import MetricsRegistry, Telemetry
from repro_torch.runtime.kvcache import BlockTable
from repro_torch.runtime.steps import pull_host

# Smallest chunked-prefill bucket: chunk sizes are drawn from the log-sized
# set {8, 16, 32, ..., prefill_chunk} (DESIGN.md §10).
CHUNK_BUCKET_MIN = 8


@dataclass(frozen=True)
class StepPlan:
    """One step's lane allocation: the prompt tokens the prefill lane may
    ingest this step."""

    chunk_budget: int


class LanePolicy:
    """Per-step token-budget split across lanes (DESIGN.md §11): each
    decoding slot consumes one budget token and the remainder funds the
    prefill lane's chunks. (The JAX package's policy also sizes the draft
    depth k; that axis arrives with the draft/verify lanes.)"""

    def __init__(self, *, token_budget: int):
        self.token_budget = token_budget

    def plan(self, *, n_decode: int) -> StepPlan:
        return StepPlan(chunk_budget=self.token_budget - n_decode)


# ------------------------------------------------------------------ requests
@dataclass
class Request:
    """One decode request: ``new_tokens`` tokens from ``first_token`` on.

    ``prompt`` (optional) is a token prefix ingested before generation
    starts (the paged engine dedupes common prompt prefixes through the
    prefix cache). ``priority`` orders preemption under pool pressure:
    lower values are evicted first.
    """

    rid: int
    new_tokens: int
    greedy: bool = True
    temperature: float = 1.0
    first_token: int = 0
    arrival_s: float = 0.0
    prompt: tuple = ()
    priority: int = 0
    # Filled by the runtime:
    tokens: list = field(default_factory=list)
    t_admit: float | None = None
    t_first: float | None = None  # first emitted token (TTFT anchor)
    t_last: float | None = None  # last emit (inter-token histogram anchor)
    t_done: float | None = None
    preemptions: int = 0

    def __post_init__(self) -> None:
        if self.prompt:
            self.first_token = int(self.prompt[0])

    @property
    def effective_prompt(self) -> tuple:
        return self.prompt if self.prompt else (self.first_token,)

    @property
    def total_tokens(self) -> int:
        """Logical KV length at completion: prompt + generated tokens."""
        return len(self.effective_prompt) + self.new_tokens

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.new_tokens

    @property
    def latency_s(self) -> float | None:
        """Arrival-to-last-token latency (the serving SLO metric)."""
        if self.t_done is None:
            return None
        return self.t_done - self.arrival_s


def poisson_arrivals(
    n: int,
    rate_hz: float,
    *,
    seed: int = 0,
    tokens_mean: float = 16.0,
    tokens_max: int | None = None,
    sample_frac: float = 0.5,
    temperature: float = 1.0,
    vocab: int | None = None,
) -> list[Request]:
    """Open-loop Poisson traffic: exponential inter-arrivals, geometric
    lengths, a Bernoulli greedy/sample mix."""
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    rng = np.random.default_rng(seed)
    reqs = []
    t = 0.0
    for rid in range(n):
        t += float(rng.exponential(1.0 / rate_hz))
        nt = int(rng.geometric(min(1.0, 1.0 / max(tokens_mean, 1.0))))
        if tokens_max is not None:
            nt = min(nt, tokens_max)
        reqs.append(
            Request(
                rid=rid,
                new_tokens=nt,
                greedy=bool(rng.random() >= sample_frac),
                temperature=temperature,
                first_token=int(rng.integers(vocab)) if vocab else 0,
                arrival_s=t,
            )
        )
    return reqs


def shared_prefix_arrivals(
    n: int,
    rate_hz: float,
    *,
    seed: int = 0,
    num_prefixes: int = 4,
    prefix_len: int = 32,
    suffix_len_mean: float = 4.0,
    tokens_mean: float = 8.0,
    tokens_max: int | None = None,
    total_max: int | None = None,
    heavy_frac: float = 0.2,
    heavy_mult: float = 6.0,
    sample_frac: float = 0.5,
    temperature: float = 1.0,
    vocab: int = 256,
    priorities: Sequence[int] = (0, 1),
) -> list[Request]:
    """Shared-prefix Poisson traffic with long-tail decode lengths: every
    prompt is one of ``num_prefixes`` common prefixes plus a short private
    suffix (DESIGN.md §9). Same draws as the JAX package for one seed."""
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    if prefix_len < 1:
        raise ValueError(f"prefix_len must be >= 1, got {prefix_len}")
    if total_max is not None and prefix_len > total_max - 2:
        raise ValueError(
            f"prefix_len={prefix_len} leaves no room for generation under "
            f"total_max={total_max}"
        )
    rng = np.random.default_rng(seed)
    prefixes = [
        tuple(int(t) for t in rng.integers(0, vocab, size=prefix_len))
        for _ in range(num_prefixes)
    ]
    reqs = []
    t = 0.0
    for rid in range(n):
        t += float(rng.exponential(1.0 / rate_hz))
        mean = tokens_mean * (
            heavy_mult if rng.random() < heavy_frac else 1.0
        )
        nt = int(rng.geometric(min(1.0, 1.0 / max(mean, 1.0))))
        if tokens_max is not None:
            nt = min(nt, tokens_max)
        ns = int(rng.geometric(min(1.0, 1.0 / max(suffix_len_mean, 1.0))))
        if total_max is not None:
            # keep prompt + generation inside a request's capacity cap
            nt = max(1, min(nt, total_max - prefix_len - 1))
            ns = max(0, min(ns, total_max - prefix_len - nt))
        suffix = tuple(int(x) for x in rng.integers(0, vocab, size=ns))
        reqs.append(
            Request(
                rid=rid,
                new_tokens=nt,
                greedy=bool(rng.random() >= sample_frac),
                temperature=temperature,
                arrival_s=t,
                prompt=prefixes[int(rng.integers(num_prefixes))] + suffix,
                priority=int(priorities[int(rng.integers(len(priorities)))]),
            )
        )
    return reqs


def attach_distinct_prompts(
    requests: Sequence[Request],
    prompt_len: int,
    *,
    vocab: int,
    seed: int = 0,
) -> list[Request]:
    """Give every request its own random ``prompt_len``-token prompt (the
    chunked-prefill scenario family, DESIGN.md §10)."""
    rng = np.random.default_rng(seed)
    for r in requests:
        r.prompt = tuple(
            int(x) for x in rng.integers(0, vocab, size=prompt_len)
        )
        r.first_token = int(r.prompt[0])
    return list(requests)


class RequestQueue:
    """Thread-safe arrival queue ordered by (arrival_s, rid)."""

    def __init__(self, requests: Iterable[Request] = ()):  # noqa: B008
        self._heap: list[tuple[float, int, Request]] = []
        self._tie = itertools.count()
        self._lock = threading.Lock()
        self.extend(requests)

    def submit(self, req: Request) -> None:
        with self._lock:
            heapq.heappush(self._heap, (req.arrival_s, next(self._tie), req))

    def extend(self, requests: Iterable[Request]) -> None:
        for r in requests:
            self.submit(r)

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def __bool__(self) -> bool:
        return len(self) > 0

    def next_arrival(self) -> float | None:
        """Arrival time of the earliest queued request (None if empty)."""
        with self._lock:
            return self._heap[0][0] if self._heap else None

    def pop_due(self, now: float, limit: int | None = None) -> list[Request]:
        """Admit: pop every request with ``arrival_s <= now`` (up to limit)."""
        out: list[Request] = []
        with self._lock:
            while self._heap and self._heap[0][0] <= now:
                if limit is not None and len(out) >= limit:
                    break
                out.append(heapq.heappop(self._heap)[2])
        return out


class Clock:
    """Wall clock with virtual fast-forward over idle gaps (no due
    arrivals, no active slots), so a low arrival rate does not stall a run."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self._offset = 0.0

    def now(self) -> float:
        return time.perf_counter() - self._t0 + self._offset

    def jump_to(self, t: float) -> None:
        """Fast-forward to virtual time ``t`` (no-op if already past it)."""
        gap = t - self.now()
        if gap > 0:
            self._offset += gap


# ------------------------------------------------------- continuous batching
@dataclass
class BatcherStats:
    steps: int = 0
    admitted: int = 0
    finished: int = 0
    tokens: int = 0
    active_slot_steps: int = 0
    idle_slot_steps: int = 0
    prompt_tokens: int = 0  # ingested (not emitted) prompt tokens
    prefill_chunks: int = 0  # chunks ingested (rows; batched calls carry >1)
    prefill_calls: int = 0  # prefill-lane calls
    chunk_bucket_crossings: int = 0
    h2d_uploads: int = 0  # host->device coordinate uploads (see _DeviceMirror)
    host_plan_ms: float = 0.0  # host time per step outside device waits
    device_wait_ms: float = 0.0  # host time blocked on d2h pulls
    d2h_transfers: int = 0
    decode_steps: int = 0
    # The metrics registry this batcher's per-lane counters and latency
    # histograms live in (DESIGN.md §14); ``lane_calls`` derives from it.
    registry: MetricsRegistry = field(
        default_factory=MetricsRegistry, repr=False, compare=False
    )

    def note_lane(self, spec_name: str) -> None:
        self.registry.inc("lane_calls_total", lane=spec_name)

    @property
    def lane_calls(self) -> dict:
        """Lane calls grouped by lane spec name (DESIGN.md §12)."""
        return self.registry.labeled_values("lane_calls_total", "lane")

    @property
    def occupancy(self) -> float:
        total = self.active_slot_steps + self.idle_slot_steps
        return self.active_slot_steps / total if total else 0.0

    @property
    def lane_steps(self) -> dict:
        return {"prefill": self.prefill_calls, "decode": self.decode_steps}


@dataclass
class PagedBatcherStats(BatcherStats):
    preemptions: int = 0
    bucket_crossings: int = 0
    starved_admissions: int = 0  # distinct requests deferred for pages
    rejected_oversize: int = 0  # requests that can never fit the page cap
    shared_tokens: int = 0  # prompt tokens skipped via the prefix cache


class _DeviceMirror:
    """Host->device upload dedup for the per-slot coordinate arrays.

    They change rarely (admits, finishes, prefill flips) relative to how
    often the step runs, so ``get`` uploads only arrays the host ``touch``ed
    since the last step, and ``put`` adopts tensors the step itself returned
    (positions, next tokens): steady-state decode uploads nothing.
    ``stats.h2d_uploads`` counts actual uploads."""

    def __init__(self, stats: BatcherStats, device: torch.device):
        self._dev: dict[str, torch.Tensor] = {}
        self._stats = stats
        self._device = device

    def touch(self, *names: str) -> None:
        for n in names:
            self._dev.pop(n, None)

    def get(self, name: str, host: np.ndarray) -> torch.Tensor:
        if name not in self._dev:
            self._dev[name] = torch.tensor(host, device=self._device)
            self._stats.h2d_uploads += 1
        return self._dev[name]

    def put(self, name: str, dev: torch.Tensor) -> None:
        self._dev[name] = dev


class PagedContinuousBatcher:
    """Continuous batching against a paged KV pool (DESIGN.md §9/§10).

    Each seated request owns a ``kvcache.BlockTable`` over the shared
    ``PagePool``; the decode lane's key is ``("cbp", slots, pages_bucket)``
    where ``pages_bucket`` is the (bucketed) widest table of a decoding slot,
    and the prefill lane's is ``("pf", slots, chunk_bucket)``.
    ``dispatch_fn(bucket)`` / ``prefill_dispatch(bucket)`` return the branch
    target for a bucket (the engine's dispatcher); the step loop calls it
    directly.

    Admission walks the ``PrefixCache``: prompt pages already populated by
    an earlier request are adopted by reference, the ingestion cursor starts
    after them, and completed prompts insert their full pages back. On pool
    exhaustion idle cached pages are evicted first, then the lowest-priority
    active request is preempted (its pages recycle; it re-queues and
    restarts) — admission never hard-rejects a request that can fit.
    """

    _decode_lane = "cbp"
    _prefill_lane = "pf"

    def __init__(
        self,
        *,
        dispatch_fn: Callable[[int], Callable],
        pool,
        prefix_cache,
        cache: Any,
        num_slots: int,
        max_pages_per_req: int,
        cache_copy: Callable[[Any, int, int], Any],
        device: torch.device | str = "cpu",
        seed: int = 0,
        prefill_dispatch: Callable[[int], Callable] | None = None,
        prefill_chunk: int = 0,
        telemetry: Telemetry | None = None,
    ):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.telemetry = telemetry or Telemetry()
        self._trace = self.telemetry.trace_or_none()
        reg = self.telemetry.registry
        self._h_qwait = reg.histogram("queue_wait_ms")
        self._h_ttft = reg.histogram("ttft_ms")
        self._h_itl = reg.histogram("inter_token_ms")
        self._h_e2e = reg.histogram("request_latency_ms")
        self._lane_hist: dict[str, Any] = {}
        self._dispatch = dispatch_fn
        self.pool = pool
        self.prefix = prefix_cache
        self._cache = cache  # pooled device pages, updated in place by steps
        self.num_slots = num_slots
        self.max_pages_per_req = max_pages_per_req
        self.device = torch.device(device)
        # device half of COW: cache_copy(cache, src, dst) -> cache
        self._cache_copy = cache_copy
        # sampled rows draw from one generator per batcher (steps.py)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._slots: list[Request | None] = [None] * num_slots
        self._tables: list[BlockTable | None] = [None] * num_slots
        self._cursor = np.zeros(num_slots, np.int64)  # next prompt index fed
        self._tok = np.zeros((num_slots, 1), np.int32)
        self._pos = np.zeros(num_slots, np.int32)
        self._active = np.zeros(num_slots, bool)
        self._temps = np.ones(num_slots, np.float32)
        self._greedy = np.ones(num_slots, bool)
        self._prompt_cached = np.zeros(num_slots, bool)
        self._pages_bucket = 1
        self._bt_host: np.ndarray | None = None
        self._bt_dirty = True  # packed decode tables need a rebuild
        # chunked prefill (DESIGN.md §10): PREFILL/DECODE state per slot
        self._prefill_dispatch = prefill_dispatch
        self.prefill_chunk = prefill_chunk if prefill_dispatch else 0
        # per-step token budget: one per decoding slot plus one full chunk
        self.token_budget = num_slots + self.prefill_chunk
        self._chunk_bucket = 0
        self._prefilling = np.zeros(num_slots, bool)
        self._chunk_slots: set[int] = set()
        self._lane_policy = LanePolicy(token_budget=self.token_budget)
        self.preempted: list[Request] = []
        self.rejected: list[Request] = []  # oversized: can never be seated
        self._starved_rids: set[int] = set()
        self.stats = PagedBatcherStats(registry=self.telemetry.registry)
        self._mirror = _DeviceMirror(self.stats, self.device)

    # ------------------------------------------------------------ properties
    @property
    def active_count(self) -> int:
        return int(self._active.sum())

    @property
    def free_slots(self) -> int:
        return self.num_slots - self.active_count

    @property
    def has_work(self) -> bool:
        return bool(self._active.any())

    @property
    def pages_bucket(self) -> int:
        return self._pages_bucket

    def live_tables(self):
        return [t for t in self._tables if t is not None]

    # ------------------------------------------------------------ telemetry
    def _lane_tick(self, lane: str, t0_ns: int) -> None:
        """Per-lane call latency (host clock, from just before the call to
        its return — the device may still be running)."""
        dt_ns = time.perf_counter_ns() - t0_ns
        h = self._lane_hist.get(lane)
        if h is None:
            h = self._lane_hist[lane] = self.telemetry.registry.histogram(
                "lane_step_ms", lane=lane
            )
        h.observe(dt_ns / 1e6)
        if self._trace is not None:
            self._trace.emit("lane_step", "lane:" + lane, ph="X", ts_ns=t0_ns,
                             dur_ns=dt_ns)

    def _note_admit(self, req: Request, now: float) -> None:
        self._h_qwait.observe(max(now - req.arrival_s, 0.0) * 1e3)
        if self._trace is not None:
            self._trace.emit("admit", "scheduler", args={"rid": req.rid})

    def _note_tokens(self, req: Request, now: float) -> None:
        """TTFT on the first emitted token, inter-token gap after it."""
        if req.t_first is None:
            req.t_first = now
            self._h_ttft.observe(max(now - req.arrival_s, 0.0) * 1e3)
        elif req.t_last is not None and now > req.t_last:
            self._h_itl.observe((now - req.t_last) * 1e3)
        req.t_last = now

    def _note_finish(self, req: Request, now: float) -> None:
        self._h_e2e.observe(max(now - req.arrival_s, 0.0) * 1e3)
        if self._trace is not None:
            self._trace.emit("finish", "scheduler",
                             args={"rid": req.rid, "tokens": len(req.tokens)})

    def _pull(self, dev: torch.Tensor) -> np.ndarray:
        """The emit-boundary d2h sync; ``device_wait_ms`` measures how long
        the host sat blocked on the device."""
        out, dt_ns = pull_host(dev, self._trace)
        self.stats.device_wait_ms += dt_ns / 1e6
        self.stats.d2h_transfers += 1
        return out

    # ------------------------------------------------------------- cold path
    def _reclaim_pages(self, want: int, requester_priority: int) -> bool:
        """Free >= ``want`` pages: evict idle prefix pages, then preempt
        strictly-lower-priority requests. False if pressure can't be met."""
        if self.pool.pages_free >= want:
            return True
        self.prefix.evict(want - self.pool.pages_free)
        while self.pool.pages_free < want:
            victim = self._pick_victim(requester_priority)
            if victim is None:
                return False
            self._preempt_slot(victim)
            self.prefix.evict(want - self.pool.pages_free)
        return True

    def _pick_victim(self, requester_priority: int) -> int | None:
        """Lowest-priority active slot strictly below the requester; ties
        break toward the most recently admitted (least sunk work)."""
        best, best_key = None, None
        for s, req in enumerate(self._slots):
            if req is None or not self._active[s]:
                continue
            if req.priority >= requester_priority:
                continue
            key = (req.priority, -(req.t_admit or 0.0))
            if best_key is None or key < best_key:
                best, best_key = s, key
        return best

    def _preempt_slot(self, s: int) -> None:
        req = self._slots[s]
        self._tables[s].release()
        self._tables[s] = None
        self._slots[s] = None
        self._active[s] = False
        self._prefilling[s] = False
        self._mirror.touch("active")
        self._bt_dirty = True
        req.tokens = []
        req.t_admit = None
        req.t_first = None  # restart: earlier progress is discarded
        req.preemptions += 1
        self.stats.preemptions += 1
        self.preempted.append(req)
        if self._trace is not None:
            self._trace.emit("preempt", "scheduler",
                             args={"rid": req.rid, "slot": s})

    def admit(self, requests: Iterable[Request], now: float = 0.0) -> list:
        """Seat requests in free slots; returns the requests deferred for
        lack of pages (callers re-queue them — admission never rejects a
        request that can fit)."""
        deferred: list[Request] = []
        free = [i for i, r in enumerate(self._slots) if r is None]
        for req in requests:
            if not free:
                raise RuntimeError(
                    "PagedContinuousBatcher.admit called with no free slot; "
                    "gate admissions on .free_slots."
                )
            prompt = req.effective_prompt
            # the last generated token is emitted but never written to KV,
            # so capacity is total_tokens - 1 positions
            need_pages = -(
                -max(req.total_tokens - 1, 1) // self.pool.page_size
            )
            if need_pages > self.max_pages_per_req:
                # can never fit, at any load: reject this one request
                self.stats.rejected_oversize += 1
                self.rejected.append(req)
                continue
            # Prefix-cache walk: adopt already-populated full prompt pages,
            # but never the page holding the last prompt token — that token
            # is re-fed to prime generation, and keeping its page private
            # makes prompt-path writes COW-free.
            pages, _ = self.prefix.match(prompt)
            usable = min(len(pages), (len(prompt) - 1) // self.pool.page_size)
            for pid in pages[usable:]:
                self.pool.decref(pid)
            pages = pages[:usable]
            matched = usable * self.pool.page_size
            table = BlockTable(pool=self.pool, pages=pages, num_tokens=matched)
            # first private page: the one the re-fed prompt token writes into
            if not self._reclaim_pages(1, req.priority) or (
                not table.ensure_capacity(matched)
            ):
                table.release()
                if req.rid not in self._starved_rids:  # count requests once
                    self._starved_rids.add(req.rid)
                    self.stats.starved_admissions += 1
                deferred.append(req)
                continue
            s = free.pop(0)
            self._slots[s] = req
            self._tables[s] = table
            self._cursor[s] = matched
            self._tok[s, 0] = prompt[matched]
            self._pos[s] = matched
            self._active[s] = True
            # PREFILL when more than the re-fed last token remains to ingest
            # and a chunked lane exists; otherwise straight to DECODE
            # (token-by-token forcing handles any prompt remainder there)
            self._prefilling[s] = (
                self.prefill_chunk > 0 and len(prompt) - matched > 1
            )
            self._temps[s] = req.temperature
            self._greedy[s] = req.greedy
            self._prompt_cached[s] = False
            req.t_admit = now
            self._note_admit(req, now)
            self._mirror.touch("tok", "pos", "active", "temps", "greedy")
            self._bt_dirty = True
            self.stats.admitted += 1
            self.stats.shared_tokens += matched
        return deferred

    def _page_upkeep(self) -> None:
        """Pre-step cold path: every decoding slot must own a writable page
        for its current position. Growth/COW happens here, never in-loop;
        the prefill lane reserves its own chunk's pages."""
        for s, req in enumerate(self._slots):
            if req is None or not self._active[s] or self._prefilling[s]:
                continue
            table = self._tables[s]
            pos = int(self._pos[s])
            need = table.page_index(pos) + 1 - table.num_pages
            if need > 0:
                self._bt_dirty = True
                if not self._reclaim_pages(need, req.priority) or (
                    not table.ensure_capacity(pos)
                ):
                    self._preempt_slot(s)  # can't grow: preempt the requester
                    continue
            if not table.ensure_writable(pos, self._device_copy_page):
                self._preempt_slot(s)

    def _device_copy_page(self, src: int, dst: int) -> None:
        self._bt_dirty = True  # COW swapped a page id in some table
        self._cache = self._cache_copy(self._cache, src, dst)

    # ------------------------------------------------------------- planning
    def _plan_step(self) -> StepPlan:
        decoding = self._active & ~self._prefilling
        return self._lane_policy.plan(n_decode=int(decoding.sum()))

    def _plan_chunks(self, budget_left: int) -> list[tuple[int, int, int]]:
        """FIFO chunk allocation for the prefill lane: earliest-admitted
        prefilling slots first, each chunk clamped to [1, prefill_chunk] —
        the head slot always progresses even on a dry budget; later slots
        only while budget remains. A slot whose chunk reaches its prompt end
        also decodes its first token this step, so the final chunk shrinks
        to keep that token inside the budget. Returns [(slot, cursor,
        chunk), ...]."""
        order = sorted(
            (
                s for s in range(self.num_slots)
                if self._prefilling[s] and self._active[s]
            ),
            key=lambda s: (self._slots[s].t_admit or 0.0, s),
        )
        out: list[tuple[int, int, int]] = []
        for s in order:
            if out and budget_left < 1:
                break
            prompt = self._slots[s].effective_prompt
            cursor = int(self._cursor[s])
            remaining = len(prompt) - cursor
            chunk = max(1, min(remaining, budget_left, self.prefill_chunk))
            if chunk == remaining and chunk + 1 > budget_left and remaining > 1:
                chunk -= 1
            out.append((s, cursor, chunk))
            budget_left -= chunk + (1 if chunk == remaining else 0)
        return out

    def _note_chunk_bucket(self, bucket: int) -> None:
        if bucket != self._chunk_bucket:
            self.stats.chunk_bucket_crossings += 1
            self._chunk_bucket = bucket

    # ------------------------------------------------------- prefill lane
    def _prefill_step(self, now: float, budget: int) -> list[Request]:
        """Ingest chunks for prefilling requests, batched (DESIGN.md §10):
        every planned chunk's pages are reserved first (reclaim, else
        preempt the requester), then every surviving slot rides one
        ``("pf", slots, chunk_bucket)`` call — per-row chunk
        windows through per-row block tables, length 0 = idle row, padded
        columns writing only the null page. The flip (prompt done) publishes
        the prompt's full pages to the prefix cache and primes generation
        with the chunk's last-row sample."""
        plan = self._plan_chunks(budget)
        for s, cursor, chunk in plan:
            req = self._slots[s]
            if req is None or not self._active[s] or not self._prefilling[s]:
                continue  # a victim of an earlier reservation's preemption
            table = self._tables[s]
            need = table.page_index(cursor + chunk - 1) + 1 - table.num_pages
            if need <= 0:
                continue
            self._bt_dirty = True
            if not self._reclaim_pages(need, req.priority) or (
                not table.ensure_capacity(cursor + chunk - 1)
            ):
                self._preempt_slot(s)
        kept = [
            (s, cursor, chunk)
            for s, cursor, chunk in plan
            if self._slots[s] is not None
            and self._active[s]
            and self._prefilling[s]
        ]
        if not kept:
            return []
        bucket = bucket_pow2(
            max(c for _, _, c in kept), CHUNK_BUCKET_MIN, self.prefill_chunk
        )
        self._note_chunk_bucket(bucket)
        step = self._prefill_dispatch(bucket)
        tok = np.zeros((self.num_slots, bucket), np.int32)
        length = np.zeros(self.num_slots, np.int32)
        bt = np.zeros((self.num_slots, self.max_pages_per_req), np.int32)
        for s, cursor, chunk in kept:
            prompt = self._slots[s].effective_prompt
            tok[s, :chunk] = prompt[cursor : cursor + chunk]
            length[s] = chunk
            table = self._tables[s]
            bt[s, : table.num_pages] = table.pages
        # chunk inputs are per-chunk data, uploaded raw
        self.stats.prefill_calls += 1
        self.stats.note_lane(self._prefill_lane)
        self.stats.h2d_uploads += 4
        dev = self.device
        t0_ns = time.perf_counter_ns()
        nxt, self._cache = step(
            self._cache,
            torch.tensor(tok, device=dev),
            torch.tensor(self._pos, device=dev),
            torch.tensor(bt, device=dev),
            torch.tensor(length, device=dev),
            self._mirror.get("temps", self._temps),
            self._mirror.get("greedy", self._greedy),
            self.generator,
        )
        self._lane_tick(self._prefill_lane, t0_ns)
        nxt_host = self._pull(nxt)
        finished: list[Request] = []
        for s, cursor, chunk in kept:
            req = self._slots[s]
            prompt = req.effective_prompt
            table = self._tables[s]
            self._chunk_slots.add(s)
            cursor += chunk
            self._cursor[s] = cursor
            self._pos[s] = cursor
            table.num_tokens = cursor
            self.stats.prompt_tokens += chunk
            self.stats.prefill_chunks += 1
            if cursor >= len(prompt):  # flip: prompt done, prime generation
                self._bt_dirty = True  # the decode tables gain this row
                full = len(prompt) // self.pool.page_size
                if full > 0:
                    self.prefix.insert(prompt, table.pages[:full])
                self._prompt_cached[s] = True
                self._prefilling[s] = False
                self._mirror.touch("active")
                token = int(nxt_host[s])
                req.tokens.append(token)
                self._note_tokens(req, now)
                self.stats.tokens += 1
                self._tok[s, 0] = token
                self._mirror.touch("tok")
                if req.done:  # new_tokens == 1: the primed token was last
                    req.t_done = now
                    self._note_finish(req, now)
                    self._release(s)
                    finished.append(req)
        self._mirror.touch("pos")
        return finished

    # -------------------------------------------------------------- hot path
    def step(self, now: float = 0.0) -> list[Request]:
        """One multi-lane step for all slots; returns finished requests.

        Cold path first (the lane plan, a batched prefill chunk, page
        upkeep, bucket dispatch — mostly no-ops), then one direct call of
        the decode lane's bound step."""
        t0 = time.perf_counter()
        dw0 = self.stats.device_wait_ms
        finished = self._step_impl(now)
        self.stats.host_plan_ms += (
            (time.perf_counter() - t0) * 1e3
            - (self.stats.device_wait_ms - dw0)
        )
        return finished

    def _step_impl(self, now: float) -> list[Request]:
        if not self._active.any():
            return []
        finished: list[Request] = []
        self._chunk_slots = set()
        plan = self._plan_step()
        if self.prefill_chunk > 0 and (self._prefilling & self._active).any():
            finished.extend(self._prefill_step(now, plan.chunk_budget))
        self._page_upkeep()
        decoding = self._active & ~self._prefilling
        if not decoding.any():
            self.stats.steps += 1  # prefill-only step
            self._count_prefill_only_step()
            return finished
        finished.extend(self._decode_lane_step(now, decoding))
        return finished

    def _decode_lane_step(self, now: float, decoding) -> list[Request]:
        """Capacity-bucket dispatch, packed block tables, one direct step
        call, one packed pull."""
        bucket = bucket_pow2(
            max(
                [t.num_pages for s, t in enumerate(self._tables)
                 if t is not None and decoding[s]] or [1]
            ) or 1,
            1,
            self.max_pages_per_req,
        )
        if bucket != self._pages_bucket:
            self.stats.bucket_crossings += 1
            self._pages_bucket = bucket
            self._bt_dirty = True  # table width changed
        step = self._dispatch(bucket)  # cold: slot-hit unless bucket moved
        if self._bt_dirty:
            bt = np.zeros((self.num_slots, bucket), np.int32)  # null page 0
            for s, table in enumerate(self._tables):
                if table is not None and decoding[s]:
                    bt[s, : table.num_pages] = table.pages
            self._bt_host = bt
            self._bt_dirty = False
            self._mirror.touch("bt")
        t0_ns = time.perf_counter_ns()
        nxt, self._cache, pos, tok_col, packed = step(
            self._cache,
            self._mirror.get("tok", self._tok),
            self._mirror.get("pos", self._pos),
            self._mirror.get("bt", self._bt_host),
            self._mirror.get("active", decoding),
            self._mirror.get("temps", self._temps),
            self._mirror.get("greedy", self._greedy),
            self.generator,
        )
        self._lane_tick(self._decode_lane, t0_ns)
        self.stats.decode_steps += 1
        self.stats.note_lane(self._decode_lane)
        self.stats.steps += 1
        self._mirror.put("pos", pos)
        self._mirror.put("tok", tok_col)  # chained on device, no upload
        p = self._pull(packed)  # [S,2]: nxt | new_pos; blocks on the step
        self._pos = np.array(p[:, 1], np.int32)
        return self._emit_decode(p[:, 0], now)

    def _emit_decode(self, nxt_host: np.ndarray, now: float) -> list[Request]:
        """The decode step's emit boundary: teacher-force remaining prompt
        tokens, publish finished prompts' pages, emit, finish."""
        finished: list[Request] = []
        self._tok = np.asarray(nxt_host)[:, None].astype(np.int32)
        self._count_prefilling_slot_steps()
        for s, req in enumerate(self._slots):
            if req is None or not self._active[s]:
                self.stats.idle_slot_steps += 1
                continue
            if self._prefilling[s]:
                continue  # chunked lane owns this slot (ticked above)
            self.stats.active_slot_steps += 1
            table = self._tables[s]
            table.num_tokens = int(self._pos[s])
            prompt = req.effective_prompt
            if self._cursor[s] + 1 < len(prompt):
                # token-by-token forcing (no chunked lane): feed the next
                # prompt token, drop the sample
                self._cursor[s] += 1
                self._tok[s, 0] = prompt[self._cursor[s]]
                self._mirror.touch("tok")
                self.stats.prompt_tokens += 1
                continue
            if not self._prompt_cached[s]:
                # prompt fully written: publish its full pages for sharing
                full = len(prompt) // self.pool.page_size
                if full > 0:
                    self.prefix.insert(prompt, table.pages[:full])
                self._prompt_cached[s] = True
            req.tokens.append(int(nxt_host[s]))
            self._note_tokens(req, now)
            self.stats.tokens += 1
            if req.done:
                req.t_done = now
                self._note_finish(req, now)
                finished.append(req)
                self._release(s)
        return finished

    def _release(self, s: int) -> None:
        """A request finished: its pages return to the pool."""
        self._tables[s].release()
        self._tables[s] = None
        self._slots[s] = None
        self._active[s] = False
        self._mirror.touch("active")
        self._bt_dirty = True
        self.stats.finished += 1

    # ------------------------------------------------------------ occupancy
    def _count_prefilling_slot_steps(self) -> None:
        """One occupancy tick per prefilling slot: active only for slots
        that received one of this step's chunks."""
        for s in range(self.num_slots):
            if self._slots[s] is None or not self._prefilling[s]:
                continue
            if s in self._chunk_slots:
                self.stats.active_slot_steps += 1
            else:
                self.stats.idle_slot_steps += 1

    def _count_prefill_only_step(self) -> None:
        """Occupancy for a step whose decode lane was skipped."""
        self._count_prefilling_slot_steps()
        for s in range(self.num_slots):
            if self._slots[s] is None or not self._prefilling[s]:
                self.stats.idle_slot_steps += 1


# ------------------------------------------------------------------ reports
def latency_report(requests: Sequence[Request], batcher=None) -> dict:
    """p50/p95/p99 latency + TTFT + throughput over finished requests, plus
    the batcher's per-lane counts and host/device split when given."""
    done = [r for r in requests if r.t_done is not None]
    lanes: dict = {}
    if batcher is not None:
        st = batcher.stats
        lanes["lane_steps"] = st.lane_steps
        lanes["lane_calls"] = dict(st.lane_calls)
        lanes["pipeline"] = {
            "host_plan_ms": round(st.host_plan_ms, 3),
            "device_wait_ms": round(st.device_wait_ms, 3),
            "d2h_transfers": st.d2h_transfers,
        }
        if st.decode_steps:
            lanes["tokens_per_target_step"] = round(
                st.tokens / st.decode_steps, 3
            )
    if not done:
        return {"finished": 0, **lanes}
    lat = np.array([r.latency_s for r in done])
    toks = sum(len(r.tokens) for r in done)
    span = max(r.t_done for r in done) - min(r.arrival_s for r in done)
    report = {
        "finished": len(done),
        "tokens": toks,
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p95_ms": float(np.percentile(lat, 95) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "mean_ms": float(lat.mean() * 1e3),
        "tok_per_s": toks / span if span > 0 else float("inf"),
        "span_s": float(span),
        **lanes,
    }
    ttft = np.array(
        [r.t_first - r.arrival_s for r in done if r.t_first is not None]
    )
    if len(ttft):  # time-to-first-token: the prompt-ingestion SLO metric
        report["ttft_p50_ms"] = float(np.percentile(ttft, 50) * 1e3)
        report["ttft_p95_ms"] = float(np.percentile(ttft, 95) * 1e3)
        report["ttft_p99_ms"] = float(np.percentile(ttft, 99) * 1e3)
        report["ttft_mean_ms"] = float(ttft.mean() * 1e3)
    return report
