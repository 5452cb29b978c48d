"""Request scheduler + continuous batching (counterpart of
``repro.runtime.scheduler``: the per-burst engine's batch forming and the
synchronous dense and paged paths).

* ``Request`` / ``RequestQueue`` / ``Clock`` and the traffic generators
  (``poisson_arrivals``, ``shared_prefix_arrivals``,
  ``attach_distinct_prompts``) are the JAX package's: the same fields
  (deadlines and the robustness outcome included) and the same draws for
  one seed.
* ``form_bursts`` — the per-burst engine's batch forming (one sampling
  mode per burst, bucketed batch sizes).
* ``ContinuousBatcher`` — slot-based continuous batching over the dense
  per-slot cache: lanes ``cb`` (one token per decoding slot), ``pfd``
  (batched chunked prefill) and, with speculation on, ``dr``/``vfd``/
  ``drp``. A join resets the slot to position 0 (per-row attention masks
  the previous occupant's rows), a leave clears its active bit.
* ``PagedContinuousBatcher`` — slot-based continuous batching against a
  paged KV pool (``runtime.kvcache``, DESIGN.md §9) with the lanes ``cbp``
  (one token per decoding slot), ``pf`` (batched chunked prefill, DESIGN.md
  §10) and, with speculation on, ``dr``/``vf``/``drp`` (DESIGN.md §11): a
  truncated-layer draft proposes K greedy candidates per slot, the target
  scores the K+1 window in one verify pass, and acceptance rewinds
  positions and trims block tables as data. Block tables map positions
  onto pooled pages (model-dtype or int8), prompts share full pages through
  the prefix cache, pool pressure evicts idle prefix pages and then
  preempts, and every lane's bucket axes are semi-static dispatch keys: a
  crossing is a rebind on the cold path, never a build.

Both batchers share ``_MultiLaneMixin``, as in the JAX package: the lane
plan, FIFO chunk allocation, bucket accounting, the flip that primes
generation, the decode emit boundary, the draft/verify accept/rollback and
the async step pipeline (DESIGN.md §13: ``async_steps`` issues step N+1
before committing step N whenever N's outcome cannot change N+1's plan);
they differ in storage (dense rows or pages) and in their targets'
signatures. Sampled rows draw from per-slot threefry keys, drawn from a
numpy generator seeded with the batcher's ``seed`` at construction and at
each admission, in the JAX package's order, and split inside every step;
so the sampled streams, like the greedy ones, equal the JAX package's.

The robustness surface (DESIGN.md §15) is the JAX package's too: mid-stream
``cancel`` and per-request deadlines (commit-then-discard under the async
pipeline), the ``set_knobs`` actuation surface the degradation ladder
drives (clamped into the warmed bucket sets), the ``step_output`` and
``d2h_stall`` fault sites with the emitted-token guard and one-retry
quarantine at every commit boundary, and an attachable step-time watchdog.
A ``FaultPlan`` counts the JAX package's opportunities: where the port
packs what the JAX package pulls separately into one transfer, that pull
counts as many ``d2h_stall`` opportunities as the JAX package's pulls.

The mesh coordinate (DESIGN.md §16-§17) is the JAX package's too:
``set_mesh`` moves a batcher (either engine's, its draft state with it) to
another warmed mesh, of one device or of several logical devices, and the
paged batcher's disaggregated mode runs the prefill lane on its own slice
and pool, migrating each prompt's pages to the decode pool at its PREFILL
-> DECODE flip (``kvcache.migrate_pages`` and the engine's ``mg``
targets); ``set_disagg`` splits and collapses mid-stream. On a pool of
several shards (a warm ladder with a data-parallel mesh) slot ``s`` is
pinned to shard ``s * shards // num_slots``, as in the JAX package: its
table allocates, adopts and prefix-matches pages of that shard only, and
pads with that shard's null page, so a mesh's data row finds every page of
its slots in its own block; copy-on-write within a table never crosses
shards. A dense cache on a mesh holds slot ``s``'s rows on data row ``s *
dp // num_slots`` (``models.tensor_parallel``), so the dense batcher's
slots are pinned by construction: any free slot is served by the row that
holds its cache. The speculative lanes follow the batcher's mesh binding
like its decode lane.
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core import bucket_multiple, bucket_pow2
from repro_torch.core.faults import POISON_TOKEN
from repro_torch.core.telemetry import MetricsRegistry, Telemetry
from repro_torch.runtime.kvcache import BlockTable, migrate_pages
from repro_torch.runtime.steps import pull_host

# Smallest chunked-prefill bucket: chunk sizes are drawn from the log-sized
# set {8, 16, 32, ..., prefill_chunk} (DESIGN.md §10).
CHUNK_BUCKET_MIN = 8


@dataclass(frozen=True)
class StepPlan:
    """One step's lane allocation: ``chunk_budget`` prompt tokens for the
    prefill lane, and the draft depth ``k`` (the k-bucket) for the
    draft/verify lanes — 0 routes decoding slots through the decode lane."""

    chunk_budget: int
    k: int = 0


class LanePolicy:
    """Per-step token-budget split across lanes (DESIGN.md §11): each
    decoding slot consumes ``1 + k`` budget tokens (its verify window) and
    the remainder funds the prefill lane's chunks. The draft depth ``k`` is
    drawn from the log-sized k-bucket set {1, 2, 4, ..., spec_k} and clamped
    by the longest useful window (``max_remaining - 1``), so k shrinks near
    stream tails and the crossing is a rebind over warmed buckets.

    ``decoupled`` (DESIGN.md §17): under disaggregated prefill/decode the
    two lanes run on disjoint slices, so decoding slots no longer eat into
    the prefill budget: the chunk budget is the whole token budget."""

    def __init__(self, *, token_budget: int, spec_k: int = 0,
                 decoupled: bool = False):
        self.token_budget = token_budget
        self.spec_k = spec_k
        self.decoupled = decoupled

    def plan(self, *, n_decode: int, max_remaining: int = 0) -> StepPlan:
        """``max_remaining`` is the largest remaining emission count over
        draft-eligible slots (0 when speculation is off or none is)."""
        k = 0
        if self.spec_k > 0 and n_decode > 0 and max_remaining > 1:
            k = bucket_pow2(min(self.spec_k, max_remaining - 1), 1, self.spec_k)
        budget = (self.token_budget if self.decoupled
                  else self.token_budget - n_decode * (1 + k))
        return StepPlan(chunk_budget=budget, k=k)


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
    # Deadlines (DESIGN.md §15). ``ttl_s`` bounds *queue wait*: a request
    # still queued ttl_s after arrival is shed before admission
    # (runtime.admission). ``deadline_s`` is the absolute clock completion
    # deadline: a seated request past it is cancelled mid-stream, its
    # slot/pages released. None = no deadline.
    ttl_s: float | None = None
    deadline_s: float | None = None
    # Filled by the runtime:
    tokens: list = field(default_factory=list)
    t_admit: float | None = None
    t_first: float | None = None  # first emitted token (TTFT anchor)
    t_last: float | None = None  # last emit (inter-token histogram anchor)
    t_done: float | None = None
    preemptions: int = 0
    shed_reason: str | None = None  # why admission dropped it (§15)
    cancelled: bool = False  # cancelled mid-stream (deadline or explicit)
    error: str | None = None  # failed after fault containment gave up
    faults: int = 0  # times this request's slot was quarantined

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


def form_bursts(
    requests: Sequence[Request], *, quantum: int, max_batch: int
) -> list[tuple[int, bool, list[Request]]]:
    """Per-burst batch forming: (bucket, greedy, requests) groups.

    Requests are split by sampling mode (a burst has one mode — the mode is
    baked into the per-burst branch target), chunked to ``max_batch``, and
    the chunk size is rounded up to a batch bucket. Every returned burst
    costs one ``Engine.set_mode`` before its hot loop."""
    bursts = []
    for greedy in (True, False):
        group = [r for r in requests if r.greedy == greedy]
        for i in range(0, len(group), max_batch):
            chunk = group[i:i + max_batch]
            bursts.append(
                (bucket_multiple(len(chunk), quantum, max_batch), greedy, chunk)
            )
    return bursts


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
    h2d_overlapped: int = 0  # ... of which staged while a step was in flight
    host_plan_ms: float = 0.0  # host time per step outside device waits
    device_wait_ms: float = 0.0  # host time blocked on d2h pulls
    d2h_transfers: int = 0
    inflight_depth: int = 0  # most issued-but-uncommitted steps at once
    # lane calls (DESIGN.md §11)
    decode_steps: int = 0
    draft_steps: int = 0
    verify_steps: int = 0
    # speculation: candidates offered vs accepted, k-bucket crossings
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    k_bucket_crossings: int = 0
    # Robustness accounting (DESIGN.md §15): mid-stream cancellations (by
    # deadline or explicit cancel), step-time stragglers flagged by an
    # attached watchdog, and fault-containment outcomes (quarantined slots
    # whose requests were re-admitted vs failed).
    cancelled: int = 0
    deadline_missed: int = 0
    stragglers: int = 0
    faults_detected: int = 0
    faults_contained: int = 0
    faults_failed: int = 0
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
    def target_steps(self) -> int:
        """Target-model decode-side calls: the denominator of tokens per
        target step."""
        return self.decode_steps + self.verify_steps

    @property
    def lane_steps(self) -> dict:
        return {
            "prefill": self.prefill_calls,
            "draft": self.draft_steps,
            "verify": self.verify_steps,
            "decode": self.decode_steps,
        }


@dataclass
class PagedBatcherStats(BatcherStats):
    preemptions: int = 0
    bucket_crossings: int = 0
    starved_admissions: int = 0  # distinct requests deferred for pages
    rejected_oversize: int = 0  # requests that can never fit the page cap
    shared_tokens: int = 0  # prompt tokens skipped via the prefix cache
    # Disaggregated prefill/decode (DESIGN.md §17): PREFILL -> DECODE flips
    # that moved pages across pools, the pages moved, and prefill-slice
    # shadow pages allocated (adopted-prefix copies and split-time copies).
    migrations: int = 0
    migrated_pages: int = 0
    pf_shadow_pages: int = 0


class _PinnedStaging:
    """Host->device uploads that never wait for the device (the async
    pipeline's, on the card): the array is copied into a pinned host buffer
    and from there with ``non_blocking=True``, behind whatever step is in
    flight on the stream. A buffer is reused only after the event recorded
    behind its copy has completed. (A copy from pageable memory makes the
    host wait for the stream, i.e. for the step in flight.)"""

    def __init__(self, device: torch.device):
        self._device = device
        self._busy: deque = deque()  # (buffer, event), in stream order
        self._free: dict = {}  # (shape, dtype) -> idle pinned buffers

    def _buffer(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        while self._busy and self._busy[0][1].query():
            buf, _ = self._busy.popleft()
            self._free.setdefault((tuple(buf.shape), buf.dtype), []).append(buf)
        idle = self._free.get((shape, dtype))
        if idle:
            return idle.pop()
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def copy(self, src: torch.Tensor, dst: torch.Tensor | None) -> torch.Tensor:
        buf = self._buffer(tuple(src.shape), src.dtype)
        buf.copy_(src)
        if dst is None:
            dst = torch.empty(src.shape, dtype=src.dtype, device=self._device)
        dst.copy_(buf, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self._device))
        self._busy.append((buf, ev))
        return dst


def _upload(host: np.ndarray, device: torch.device,
            dst: torch.Tensor | None = None,
            staging: _PinnedStaging | None = None) -> torch.Tensor:
    """One host->device transfer: into ``dst`` (a graph target's static
    input) when given — same shape and dtype, or ``ValueError``, since
    ``copy_`` would cast silently — else into a fresh tensor (never one
    that shares the host array's memory); through ``staging`` when given."""
    src = torch.from_numpy(np.ascontiguousarray(host))
    if dst is not None and (src.shape != dst.shape or src.dtype != dst.dtype):
        raise ValueError(
            f"upload of {tuple(src.shape)} {src.dtype} into a static input "
            f"of {tuple(dst.shape)} {dst.dtype}"
        )
    if staging is not None:
        return staging.copy(src, dst)
    if dst is None:
        return src.to(device, copy=True)
    return dst.copy_(src)


def _static_inputs(step: Callable) -> tuple:
    """A graph target's static inputs in call order (uploads land there
    directly); ``None`` for each input of an eager target."""
    return getattr(step, "static_inputs", None) or (None,) * 8


class _DeviceMirror:
    """Host->device upload dedup for the per-slot coordinate arrays.

    They change rarely (admits, finishes, prefill flips) relative to how
    often the step runs, so ``get`` uploads only arrays the host ``touch``ed
    since the last step — into ``dst``, the calling graph target's static
    input, when there is one — and ``put`` adopts tensors the step itself
    returned (positions, next tokens): steady-state decode uploads nothing.
    ``put`` takes a graph target's chained outputs, which are its own
    static inputs, never a static output of a graph: the next replay of any
    graph in the engine's pool may overwrite those. ``stats.h2d_uploads``
    counts actual uploads. Under the async pipeline on the card every upload
    goes through ``staging`` (``_PinnedStaging``)."""

    def __init__(self, stats: BatcherStats, device: torch.device):
        self._dev: dict[str, torch.Tensor] = {}
        self._stats = stats
        self._device = device
        self.staging: _PinnedStaging | None = None

    def touch(self, *names: str) -> None:
        for n in names:
            self._dev.pop(n, None)

    def get(self, name: str, host: np.ndarray,
            dst: torch.Tensor | None = None) -> torch.Tensor:
        if name not in self._dev:
            self._dev[name] = _upload(host, self._device, dst, self.staging)
            self._stats.h2d_uploads += 1
        return self._dev[name]

    def put(self, name: str, dev: torch.Tensor) -> None:
        self._dev[name] = dev

    def invalidate(self, device: torch.device) -> None:
        """Drop every device copy: a mesh rebind moved the serving state
        to ``device`` (DESIGN.md §16), and the next ``get`` of each name
        uploads the host copy there."""
        self._dev.clear()
        self._device = device

    def detach(self) -> None:
        """Hold copies of its own of every device array: another batcher's
        calls (or a new batcher's warmup) are about to replay the graph
        targets whose static inputs these may be. The next call copies them
        back in as it copies any argument that is not already static."""
        self._dev = {n: t.clone() for n, t in self._dev.items()}

    def preload(self, name: str, host: np.ndarray) -> None:
        """Double-buffered upload (DESIGN.md §13): stage a touched array
        while a step is in flight, so its copy rides that step's execution
        and the next ``get`` is a hit (a graph target then copies it into
        its static input on the device). A later ``touch`` still drops it,
        so correctness never depends on the overlap."""
        if name not in self._dev:
            self._dev[name] = _upload(host, self._device, None, self.staging)
            self._stats.h2d_uploads += 1
            self._stats.h2d_overlapped += 1


@dataclass
class _InflightStep:
    """One issued-but-uncommitted step (DESIGN.md §13). ``packed`` is the
    step's one host-bound output, already on its way off the device
    (``_MultiLaneMixin._stage_pull``): a decode step's ``[next_tok | new_pos
    | keys]``, a non-flip prefill chunk's ``[sample | keys]`` (only the keys
    are read back; its bookkeeping ran at issue), a spec step's verify rows
    (``[rows | next0 | keys]``). A spec step keeps its draft candidates and
    window lengths, so accept/rollback replays one step late against the
    pulled rows."""

    kind: str  # "decode" | "prefill" | "spec"
    packed: Any  # (host buffer, event or None), pulled once at commit
    chainable: bool = False  # a later step may issue before this commits
    drafts: np.ndarray | None = None  # spec: host [S, K] candidates
    lengths: np.ndarray | None = None  # spec: verify-window lengths
    k: int = 0  # spec: the step's k bucket


class _MultiLaneMixin:
    """The multi-lane step core shared by both batchers (DESIGN.md §10/§11):
    telemetry, the per-step ``LanePolicy`` plan, FIFO chunk allocation,
    chunk/k bucket accounting, flip-time first-token priming, the decode
    lane's emit boundary, the draft lane and the accept/rollback arithmetic
    of the verify lane. The engines differ only in storage bookkeeping
    (dense rows or pages, through the ``_page_upkeep`` / ``_sync_slot`` /
    ``_before_emit`` / ``_after_commit`` / ``_release`` hooks) and in their
    targets' signatures. The ``_*_lane`` names are each engine's lane specs
    in the ``core.lanes`` registry, so ``stats.lane_calls`` groups calls
    under the names the dispatch keys carry."""

    _decode_lane = "cb"
    _prefill_lane = "pfd"
    _verify_lane = "vfd"
    # The active mesh coordinate (DESIGN.md §16): the engine passes its
    # launch mesh and ``set_mesh`` moves it; ``_mesh_ctl`` is the engine's
    # topology-flip closure.
    mesh = "1x1"
    _mesh_ctl = None
    # Disaggregated prefill/decode (DESIGN.md §17): True while the prefill
    # lane runs on its slice. The dense engine never sets it.
    disagg = False

    def _init_slots(self, num_slots: int, device, seed: int,
                    telemetry: Telemetry | None) -> None:
        """Per-slot host state, the key generator and telemetry."""
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
        self.num_slots = num_slots
        self.device = torch.device(device)
        # per-slot threefry keys (uint32), drawn here and at each admission
        # in the JAX package's order, and split inside every sampling step
        self._rng = np.random.default_rng(seed)
        self._slots: list[Request | None] = [None] * num_slots
        self._cursor = np.zeros(num_slots, np.int64)  # next prompt index fed
        self._tok = np.zeros((num_slots, 1), np.int32)
        self._pos = np.zeros(num_slots, np.int32)
        self._active = np.zeros(num_slots, bool)
        self._temps = np.ones(num_slots, np.float32)
        self._greedy = np.ones(num_slots, bool)
        self._keys = self._draw_keys(num_slots, 2)
        # chunked prefill (DESIGN.md §10): PREFILL/DECODE state per slot
        self._prefilling = np.zeros(num_slots, bool)
        self._chunk_slots: set[int] = set()
        self._flip_slots: set[int] = set()  # flipped to DECODE this step
        # Overload/fault hardening (DESIGN.md §15). All inert by default:
        # un-attached, each costs one None-check (or, for deadlines, one
        # bool check) per step.
        self._watchdog = None  # ft.failover.StepTimeWatchdog
        self._on_straggler: Callable[[float], None] | None = None
        self._faults = None  # core.faults.FaultPlan
        self._stall_pending = False  # an injected d2h stall awaits detection
        self._has_deadlines = False  # any seated request carries deadline_s
        self._fault_retry_limit = 1  # re-admissions before a request fails
        self.cancelled_requests: list[Request] = []
        self.failed_requests: list[Request] = []
        self.requeued: list[Request] = []  # quarantined, to be re-admitted

    def _draw_keys(self, *shape: int) -> np.ndarray:
        return self._rng.integers(0, 2**32, size=shape, dtype=np.uint32)

    @property
    def _keys_i32(self) -> np.ndarray:
        """The keys' bits as the steps take them (int32)."""
        return self._keys.view(np.int32)

    def _init_lanes(
        self,
        *,
        prefill_dispatch: Callable[[int], Callable] | None,
        prefill_chunk: int,
        draft_dispatch: Callable[[int], Callable] | None,
        verify_dispatch: Callable[[int], Callable] | None,
        draft_prefill_dispatch: Callable[[int], Callable] | None,
        draft_cache: Any,
        spec_k: int,
        async_steps: bool = False,
        async_depth: int = 2,
        storage: Any = None,
        token_budget: int = 0,
    ) -> None:
        """Lane wiring shared by both constructors. Speculation is on only
        when the engine supplied both spec lanes. ``async_depth`` is the
        pipeline's issued-step capacity (DESIGN.md §13): at most
        ``async_depth - 1`` steps stay parked after a ``step()`` returns, so
        2 (the default) is the one-deep overlap and 1 degrades async mode
        to the synchronous commit. ``storage`` is the engine's claim on the
        tensors this batcher's targets run over, which other batchers of the
        same key share (``serve._Owner``): every step claims it first, so
        the cache holds this batcher's state, and it detaches the device
        mirror when another batcher is about to run those targets."""
        self._storage = storage
        if storage is not None:
            storage.mirror = self._mirror
        self.async_steps = bool(async_steps)
        self.async_depth = max(1, int(async_depth))
        self._inflight: deque[_InflightStep] = deque()  # issued, uncommitted
        self._backlog: list[Request] = []  # finished off the step path
        self._pull_buffers: dict = {}  # (shape, dtype) -> idle pinned buffers
        if self.async_steps and self.device.type == "cuda":
            self._mirror.staging = _PinnedStaging(self.device)
        self._prefill_dispatch = prefill_dispatch
        self.prefill_chunk = prefill_chunk if prefill_dispatch else 0
        # per-step token budget: by default one per decoding slot plus one
        # full chunk
        self.token_budget = token_budget or (
            self.num_slots + self.prefill_chunk)
        self._chunk_bucket = 0
        self._draft_dispatch = draft_dispatch
        self._verify_dispatch = verify_dispatch
        self._draft_prefill_dispatch = draft_prefill_dispatch
        self._draft_cache = draft_cache  # dense per-slot, updated in place
        self.spec_k = spec_k if (draft_dispatch and verify_dispatch) else 0
        self._k_bucket: int | None = None  # unset until the first spec step
        # per-slot, per-verify a/k acceptance samples (a bounded window)
        self.accept_samples: deque[float] = deque(maxlen=4096)
        self._lane_policy = LanePolicy(
            token_budget=self.token_budget, spec_k=self.spec_k,
            decoupled=self.disagg,
        )
        # Launch-time knob ceilings: ``set_knobs`` (the degradation ladder's
        # actuation surface) may move spec_k/prefill_chunk/token_budget only
        # within the ranges whose dispatch keys warmup built.
        self._spec_max = self.spec_k
        self._chunk_max = self.prefill_chunk
        self._budget_max = self.token_budget

    # ------------------------------------------------------------ properties
    @property
    def active_count(self) -> int:
        return int(self._active.sum())

    @property
    def free_slots(self) -> int:
        return self.num_slots - self.active_count

    @property
    def has_work(self) -> bool:
        return bool(self._active.any()) or bool(self._inflight)

    @property
    def _spec_on(self) -> bool:
        return self.spec_k > 0

    def _upload(self, host: np.ndarray, dst: torch.Tensor | None):
        """A per-step (unmirrored) upload, staged under the async
        pipeline on the card."""
        return _upload(host, self.device, dst, self._mirror.staging)

    # ------------------------------------------------------------ telemetry
    def _lane_tick(self, lane: str, t0_ns: int) -> None:
        """Per-lane call latency (host clock, from just before the call to
        its return — the device may still be running). The histogram
        carries a ``mesh`` label off the classic ``"1x1"`` (DESIGN.md §16),
        so a rebind's latency shift is visible."""
        dt_ns = time.perf_counter_ns() - t0_ns
        h = self._lane_hist.get(lane)
        if h is None:
            labels = {"lane": lane}
            if self.mesh != "1x1":
                labels["mesh"] = self.mesh
            h = self._lane_hist[lane] = self.telemetry.registry.histogram(
                "lane_step_ms", **labels
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

    def _stall_site(self, opportunities: int = 1) -> None:
        """The ``d2h_stall`` fault site: ``opportunities`` host-blocking
        pulls of the JAX package (its synchronous decode pulls the next
        token, the positions and the keys apart; the port packs them into
        one transfer), each one opportunity of the plan. A fired fault
        sleeps its ``stall_s`` (a simulated interconnect stall) for the
        watchdog to flag."""
        for _ in range(opportunities):
            f = self._faults.fire("d2h_stall")
            if f is not None:
                time.sleep(f.stall_s)
                self._stall_pending = True

    def _pull(self, dev: torch.Tensor, opportunities: int = 1) -> np.ndarray:
        """The emit-boundary d2h sync; ``device_wait_ms`` measures how long
        the host sat blocked on the device. ``opportunities`` is the
        ``d2h_stall`` count of the pull (``_stall_site``)."""
        if self._faults is not None:
            self._stall_site(opportunities)
        out, dt_ns = pull_host(dev, self._trace)
        self.stats.device_wait_ms += dt_ns / 1e6
        self.stats.d2h_transfers += 1
        return out

    # ------------------------------------------------- step pipeline (§13)
    def _stage_pull(self, packed: torch.Tensor) -> tuple:
        """Start a parked step's pull at issue: ``packed`` may be a graph's
        static output, which the next replay of any graph in the engine's
        pool overwrites. On the card it is copied with ``non_blocking`` into
        a pinned buffer of the record's own, behind an event; on the CPU it
        is copied at once."""
        if packed.device.type != "cuda":
            return packed.clone(), None
        key = (tuple(packed.shape), packed.dtype)
        idle = self._pull_buffers.get(key)
        buf = idle.pop() if idle else torch.empty(
            key[0], dtype=key[1], pin_memory=True)
        buf.copy_(packed, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return buf, ev

    def _pull_staged(self, staged: tuple) -> np.ndarray:
        """Commit's pull of a parked step: wait for its copy (the only sync
        of the async loop; ``device_wait_ms`` times it) and read the
        buffer, which goes back to the idle set."""
        buf, ev = staged
        if self._faults is not None:
            self._stall_site()
        t0 = time.perf_counter_ns()
        if ev is not None:
            ev.synchronize()
        out = buf.numpy().copy()
        dt = time.perf_counter_ns() - t0
        if ev is not None:
            self._pull_buffers.setdefault(
                (tuple(buf.shape), buf.dtype), []).append(buf)
        if self._trace is not None:
            self._trace.emit(
                "d2h", "scheduler", ph="X", ts_ns=t0, dur_ns=dt,
                args={"nbytes": int(out.nbytes), "shape": list(out.shape)},
            )
        self.stats.device_wait_ms += dt / 1e6
        self.stats.d2h_transfers += 1
        return out

    def step(self, now: float = 0.0) -> list[Request]:
        """One scheduler step; returns the requests that finished.

        Cold path first (the lane plan, a batched prefill chunk, page
        upkeep, bucket dispatch — mostly no-ops), then one direct call of
        the decode lane's target (or the draft/verify pair). Synchronous
        mode commits each step before it returns. Async mode keeps up to
        ``async_depth - 1`` issued steps parked: while every parked step is
        one whose outcome cannot change what the host plans next
        (``chainable`` decodes, non-flip prefill chunks), the next step is
        issued first and the oldest parked steps are committed while the
        device runs it. Any step the host must read before planning (spec
        accept/rollback, prefill flips, finishes, prompt forcing) commits
        first, so the sequence of calls on the device — and every token
        stream — is the synchronous loop's. Seated requests past their
        ``deadline_s`` are cancelled first; an attached watchdog observes
        the step's wall time last."""
        t0 = time.perf_counter()
        dw0 = self.stats.device_wait_ms
        if self._storage is not None:
            self._storage.claim()
        if self._has_deadlines:
            self._cancel_overdue(now)
        finished = self._backlog
        self._backlog = []
        ran_ahead = False
        if self.async_steps and self._inflight:
            if self._can_run_ahead():
                finished.extend(self._run_ahead(now))
                ran_ahead = True
            else:
                finished.extend(self._commit_pending(now))
        if not ran_ahead:
            finished.extend(self._step_impl(now))
        limit = self.async_depth - 1 if self.async_steps else 0
        while len(self._inflight) > limit:
            finished.extend(self._commit_oldest(now))
        self.stats.host_plan_ms += (
            (time.perf_counter() - t0) * 1e3
            - (self.stats.device_wait_ms - dw0)
        )
        if self._watchdog is not None:
            self._watchdog_tick(time.perf_counter() - t0)
        return finished

    def flush(self, now: float = 0.0) -> list[Request]:
        """Drain the pipeline: commit every parked step and return every
        finished request not yet handed out. Call after a stream's last
        ``step``; a no-op in synchronous mode."""
        finished = self._backlog
        self._backlog = []
        finished.extend(self._commit_pending(now))
        return finished

    def _can_run_ahead(self) -> bool:
        """Issue-before-commit is legal only when the newest parked step
        cannot change the next step's plan: a chainable decode or a parked
        non-flip prefill chunk; with prefilling slots, only when this
        step's own chunk plan flips none of them (a flip edits the decoding
        mask the parked steps were issued under) and no spec step is
        planned. Disaggregated prefill always commits first: its chunks
        bridge two pools."""
        if not self._inflight:
            return False
        rec = self._inflight[-1]
        if rec.kind == "spec" or not rec.chainable:
            return False
        if not (self._prefilling & self._active).any():
            return True
        if self.prefill_chunk <= 0 or self.disagg or self._spec_on:
            return False
        plan = self._plan_step()
        if plan.k > 0:
            return False
        return not self._flip_planned(plan.chunk_budget)

    def _flip_planned(self, budget: int) -> bool:
        """Would this step's chunk plan flip some slot PREFILL -> DECODE?
        (``_plan_chunks`` has no side effects.)"""
        return self._flip_planned_in(self._plan_chunks(budget))

    def _run_ahead(self, now: float) -> list[Request]:
        """The overlap step: issue step N+1 against the mirror's chained
        device tensors (step N's outputs are already its inputs), then let
        ``step``'s depth limit pull and emit the oldest parked steps while
        the device runs N+1. A planned non-flip chunk issues and parks as a
        decode does."""
        if self._trace is not None:
            self._trace.emit("async_issue", "scheduler")
        self._pre_issue_fast()
        finished: list[Request] = []
        self._chunk_slots = set()
        self._flip_slots = set()
        prefilling = (
            self.prefill_chunk > 0
            and bool((self._prefilling & self._active).any())
        )
        if prefilling:
            # upkeep's preemptions may have turned the plan into a flip (or
            # freed every decoding slot): re-check, else take the
            # synchronous path on a drained pipeline
            plan = self._plan_step()
            if plan.k > 0 or self._flip_planned(plan.chunk_budget):
                finished.extend(self._commit_pending(now))
                finished.extend(self._step_impl(now))
                return finished
        decoding = self._active & ~self._prefilling
        if not decoding.any() and not prefilling:
            finished.extend(self._commit_pending(now))
            return finished
        # stage upkeep-touched inputs while the parked steps run
        self._preload_step_inputs()
        if prefilling:
            finished.extend(self._prefill_step(now, plan.chunk_budget))
            decoding = self._active & ~self._prefilling
        if decoding.any():
            finished.extend(self._decode_lane_step(now, decoding))
        else:
            self.stats.steps += 1  # prefill-only step
            self._count_prefill_only_step()
        return finished

    def _pre_issue_fast(self) -> None:
        """Cold-path upkeep an issued decode needs even on the run-ahead
        path (the paged engine's page upkeep)."""

    def _preload_step_inputs(self) -> None:
        """Stage every per-slot array whose device copy was dropped — at
        admission and under run-ahead, while a parked step holds the device
        — so the next issue uploads nothing (the paged engine adds its
        packed block table)."""
        m = self._mirror
        m.preload("tok", self._tok)
        m.preload("pos", self._pos)
        m.preload("active", self._active & ~self._prefilling)
        m.preload("temps", self._temps)
        m.preload("greedy", self._greedy)
        m.preload("keys", self._keys_i32)

    def _decode_chainable(self, decoding) -> bool:
        """True when the next step's plan does not depend on this decode's
        outputs for any decoding slot: past prompt forcing (the next input
        token is the step's own output, chained on the device), not
        finishing, and not about to enter the draft/verify lanes."""
        for s, req in enumerate(self._slots):
            if req is None or not decoding[s]:
                continue
            if self._cursor[s] + 1 < len(req.effective_prompt):
                return False
            rem_after = req.new_tokens - len(req.tokens) - 1
            if rem_after < 1:
                return False
            if self._spec_on and req.greedy and rem_after > 1:
                return False
        return True

    def _queue_decode(self, packed: torch.Tensor, decoding) -> None:
        """Park a just-issued decode. Positions advance predictively — the
        device computes ``pos + active`` and the host mirrors it, so the
        next plan needs no pull (commit reads the device's own
        ``new_pos``)."""
        new_pos = np.array(self._pos, np.int32)
        new_pos[decoding] += 1
        self._pos = new_pos
        self._park(_InflightStep(
            kind="decode", packed=self._stage_pull(packed),
            chainable=self._decode_chainable(decoding),
        ))

    def _parks(self, plan: list) -> bool:
        """Under async a planned chunk that flips no slot leaves every plan
        input untouched: it issues and parks like a chainable decode (with
        speculation on, and disaggregated, chunks commit at once)."""
        return (self.async_steps and not self._spec_on and not self.disagg
                and not self._flip_planned_in(plan))

    def _flip_planned_in(self, plan: list) -> bool:
        return any(
            cursor + chunk >= len(self._slots[s].effective_prompt)
            for s, cursor, chunk in plan
        )

    def _park_prefill(self, plan: list, new_keys: torch.Tensor,
                      packed: torch.Tensor) -> None:
        """A parked chunk's bookkeeping runs at issue (its plan is final);
        its split keys chain on the device, and its pull waits for the
        pipeline's next emit boundary."""
        self._mirror.put("keys", new_keys)
        for s, cursor, chunk in plan:
            self._chunk_slots.add(s)
            cursor += chunk
            self._cursor[s] = cursor
            self._pos[s] = cursor
            self._sync_slot(s, cursor)
            self.stats.prompt_tokens += chunk
            self.stats.prefill_chunks += 1
        self._mirror.touch("pos")
        self._queue_prefill(packed)

    def _queue_prefill(self, packed: torch.Tensor) -> None:
        """Park a just-issued non-flip prefill chunk: its bookkeeping ran
        at issue and commit only reads its keys back. Always chainable."""
        self._park(_InflightStep(kind="prefill",
                                 packed=self._stage_pull(packed),
                                 chainable=True))

    def _park(self, rec: _InflightStep) -> None:
        self._inflight.append(rec)
        self.stats.inflight_depth = max(
            self.stats.inflight_depth, len(self._inflight)
        )
        if self._trace is not None:
            self._trace.emit("async_park", "scheduler",
                             args={"kind": rec.kind,
                                   "chainable": rec.chainable})

    def _commit_oldest(self, now: float) -> list[Request]:
        return self._commit_rec(self._inflight.popleft(), now)

    def _commit_pending(self, now: float) -> list[Request]:
        """Commit every parked step, oldest first (issue order), so the
        host's state converges to the device's."""
        out: list[Request] = []
        while self._inflight:
            out.extend(self._commit_oldest(now))
        return out

    def _commit_rec(self, rec: _InflightStep, now: float) -> list[Request]:
        """The emit boundary of a parked step: its one pull, then exactly
        the bookkeeping the synchronous loop runs after its call."""
        if self._trace is not None:
            self._trace.emit("async_commit", "scheduler",
                             args={"kind": rec.kind})
        p = self._pull_staged(rec.packed)
        if rec.kind == "spec":
            return self._commit_spec(p, rec, now)
        if rec.kind == "prefill":
            # [S,3]: sample | keys. Idle rows kept their keys (steps.py),
            # so adopting the whole array is exact for every slot.
            self._keys = p[:, 1:3].astype(np.uint32)
            return []
        self._keys = p[:, 2:4].astype(np.uint32)  # [S,4]: nxt | pos | keys
        return self._emit_decode(p[:, 0], p[:, 1], now)

    def _commit_spec(self, p: np.ndarray, rec: _InflightStep,
                     now: float) -> list[Request]:
        """Accept/rollback from the pulled ``[S, K+4]`` verify rows and the
        record's candidates: the same arithmetic the synchronous loop runs
        at once, so the committed stream (every rollback included) is the
        same."""
        k = rec.k
        self._keys = p[:, k + 2 : k + 4].astype(np.uint32)
        return self._apply_verify(now, p[:, : k + 1], p[:, k + 1],
                                  rec.drafts, rec.lengths)

    # ------------------------------------------------------------- planning
    def _plan_step(self) -> StepPlan:
        """The lane policy's budget split. Draft eligibility (greedy, past
        any token-by-token prompt forcing) is computed here on the cold
        path; per-slot verify windows are clamped later as data."""
        decoding = self._active & ~self._prefilling
        max_rem = 0
        if self._spec_on:
            for s, req in enumerate(self._slots):
                if req is None or not decoding[s] or not req.greedy:
                    continue
                if self._cursor[s] + 1 < len(req.effective_prompt):
                    continue  # still forcing prompt tokens
                max_rem = max(max_rem, req.new_tokens - len(req.tokens))
        return self._lane_policy.plan(
            n_decode=int(decoding.sum()), max_remaining=max_rem
        )

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

    def _chunk_bucket_for(self, plan: list) -> int:
        """The chunk bucket of a planned prefill call (crossings counted)."""
        bucket = bucket_pow2(
            max(c for _, _, c in plan), CHUNK_BUCKET_MIN, self.prefill_chunk
        )
        if bucket != self._chunk_bucket:
            self.stats.chunk_bucket_crossings += 1
            self._chunk_bucket = bucket
        return bucket

    def _note_k_bucket(self, k: int) -> None:
        """k-axis crossing accounting: another draft depth re-dispatches the
        draft/verify targets, a rebind over warmed buckets. The first spec
        step binds rather than crosses."""
        if self._k_bucket is not None and k != self._k_bucket:
            self.stats.k_bucket_crossings += 1
        self._k_bucket = k

    # ------------------------------------------------------- prefill lane
    def _mirror_draft_prompt(self, bucket: int, tok_dev, start_dev,
                             length_dev, keys_dev) -> None:
        """Draft prompt mirror (DESIGN.md §11): with speculation on, the
        draft stack ingests the same chunk windows into its dense cache
        from the prefill call's device inputs, so its KV tracks the
        committed stream before the draft lane runs."""
        if not self._spec_on or self._draft_prefill_dispatch is None:
            return
        dstep = self._draft_prefill_dispatch(bucket)
        self.stats.note_lane("drp")
        t0_ns = time.perf_counter_ns()
        # the sample and the split keys are discarded
        _, self._draft_cache, _, _ = dstep(
            self._draft_cache, tok_dev, start_dev, length_dev,
            self._mirror.get("temps", self._temps),
            self._mirror.get("greedy", self._greedy),
            keys_dev,
        )
        self._lane_tick("drp", t0_ns)

    def _prime_first_token(self, s: int, req: Request, token: int,
                           now: float) -> None:
        """Flip tail: PREFILL -> DECODE; the chunk's last-row sample is the
        request's first emitted token (its TTFT anchor)."""
        self._prefilling[s] = False
        self._flip_slots.add(s)  # its first token is budgeted
        self._mirror.touch("active")  # the decoding mask just changed
        req.tokens.append(token)
        self._note_tokens(req, now)
        self.stats.tokens += 1
        self._tok[s, 0] = token
        self._mirror.touch("tok")

    # -------------------------------------------------------------- hot path
    def _step_impl(self, now: float) -> list[Request]:
        """Lane order (DESIGN.md §11): prefill chunks first, then either the
        draft/verify pair (speculation planned this step) or the decode
        lane for the decoding slots — every lane one direct call of a
        warmed target, whatever the request mix."""
        if not self._active.any():
            return []
        finished: list[Request] = []
        self._chunk_slots = set()
        self._flip_slots = set()
        plan = self._plan_step()
        if self.prefill_chunk > 0 and (self._prefilling & self._active).any():
            finished.extend(self._prefill_step(now, plan.chunk_budget))
        self._page_upkeep(plan.k)
        decoding = self._active & ~self._prefilling
        if not decoding.any():
            self.stats.steps += 1  # prefill-only step
            self._count_prefill_only_step()
            return finished
        if plan.k > 0:  # the draft/verify lanes replace the decode lane
            finished.extend(self._spec_step(now, plan.k, decoding))
            self.stats.steps += 1
            self._count_prefilling_slot_steps()
            return finished
        finished.extend(self._decode_lane_step(now, decoding))
        return finished

    def _commit_decode(self, t0_ns: int, out: tuple, decoding,
                       now: float) -> list:
        """After the decode lane's call: chain its next token, positions
        and keys on the device; then either park the step (async) or make
        its one packed pull and run the emit boundary."""
        nxt, self._cache, pos, keys, tok_col, packed = out
        self._lane_tick(self._decode_lane, t0_ns)
        self.stats.decode_steps += 1
        self.stats.note_lane(self._decode_lane)
        self.stats.steps += 1
        # chained on device, no upload (with graphs: the target's own
        # static inputs, which its replay wrote)
        self._mirror.put("pos", pos)
        self._mirror.put("keys", keys)
        self._mirror.put("tok", tok_col)
        if self.async_steps:
            self._queue_decode(packed, decoding)
            return []
        # [S,4]: nxt | new_pos | keys; blocks. Three d2h_stall
        # opportunities: the JAX package pulls the three apart.
        p = self._pull(packed, opportunities=3)
        self._pos = np.array(p[:, 1], np.int32)
        self._keys = p[:, 2:4].astype(np.uint32)
        return self._emit_decode(p[:, 0], p[:, 1], now)

    def _emit_decode(self, nxt_host: np.ndarray, pos_host: np.ndarray,
                     now: float) -> list[Request]:
        """The decode step's emit boundary: teacher-force remaining prompt
        tokens (``prefill_chunk == 0``), emit, finish. ``pos_host`` is the
        committed step's own positions (under run-ahead ``self._pos`` is
        already a step further)."""
        finished: list[Request] = []
        if self._faults is not None:
            nxt_host, _ = self._inject_step_output(nxt_host)
        self._tok = np.asarray(nxt_host)[:, None].astype(np.int32)
        self._count_prefilling_slot_steps()
        for s, req in enumerate(self._slots):
            if req is None or not self._active[s]:
                self.stats.idle_slot_steps += 1
                continue
            if self._prefilling[s]:
                continue  # chunked lane owns this slot (ticked above)
            self.stats.active_slot_steps += 1
            self._sync_slot(s, int(pos_host[s]))
            prompt = req.effective_prompt
            if self._cursor[s] + 1 < len(prompt):
                # token-by-token forcing (no chunked lane): feed the next
                # prompt token, drop the sample
                self._cursor[s] += 1
                self._tok[s, 0] = prompt[self._cursor[s]]
                self._mirror.touch("tok")
                self.stats.prompt_tokens += 1
                continue
            self._before_emit(s, req)
            if int(nxt_host[s]) < 0:
                # NaN guard (§15): invalid token id — quarantine this slot
                self._quarantine_slot(s, now)
                continue
            req.tokens.append(int(nxt_host[s]))
            self._note_tokens(req, now)
            self.stats.tokens += 1
            if req.done:
                req.t_done = now
                self._note_finish(req, now)
                finished.append(req)
                self._release(s)
        return finished

    # ---------------------------------------------------- draft/verify lanes
    def _verify_len(self, s: int, k: int) -> int:
        """Slot ``s``'s verify-window length (0 = not in the lane): 1 +
        min(k, remaining - 1) for draft-eligible slots, which keeps every
        write inside the request's capacity; sampling slots, prompt-forcing
        slots and slots that flipped this step ride with length 1 — a verify
        of length 1 is a decode step."""
        req = self._slots[s]
        if req is None or not self._active[s] or self._prefilling[s]:
            return 0
        if (
            not req.greedy
            or s in self._flip_slots
            or self._cursor[s] + 1 < len(req.effective_prompt)
        ):
            return 1
        return 1 + min(k, max(req.new_tokens - len(req.tokens) - 1, 0))

    def _run_draft(self, k: int, decoding) -> np.ndarray:
        """Draft lane: K greedy candidates per slot in one call. The draft
        writes its own KV for the fed token at ``pos``, which is how its
        cache tracks the committed stream (rejected tails are overwritten
        once ``pos`` is rewound). Greedy is forced on (an all-ones vector,
        uploaded once), so candidates are deterministic; the keys the draft
        splits are discarded, so the sampled streams are untouched. Returns
        the host [S, K] candidates — an inherent sync, since the host packs
        the verify windows from them.

        The draft lanes' targets are keyed by slots, k and the draft dtype,
        not by the pool, so every batcher of the engine on one slot count
        (the overload stream's int8 standby too) shares them: a mirrored upload
        lands in a tensor of this batcher's own, never in a shared target's
        static input, which the other batcher's call would overwrite; and
        the dispatch puts this batcher's own draft state back into the
        shared draft cache first (the engine's ``_StorageBank``)."""
        step = self._draft_dispatch(k)  # cold: slot-hit unless k moved
        t0_ns = time.perf_counter_ns()
        drafts, self._draft_cache, _, _ = step(
            self._draft_cache,
            self._mirror.get("tok", self._tok),
            self._mirror.get("pos", self._pos),
            self._mirror.get("active", decoding),
            self._mirror.get("temps", self._temps),
            self._mirror.get("spec_greedy", np.ones(self.num_slots, bool)),
            self._mirror.get("keys", self._keys_i32),
        )
        self._lane_tick("dr", t0_ns)
        self.stats.draft_steps += 1
        self.stats.note_lane("dr")
        return self._pull(drafts)

    @staticmethod
    def _accepted_prefix(drafts_row, rows_row, k_s: int) -> int:
        """Greedy acceptance: the longest prefix where the draft's candidate
        equals the target's own greedy continuation."""
        a = 0
        while a < k_s and int(drafts_row[a]) == int(rows_row[a]):
            a += 1
        return a

    def _pack_verify_tok(self, drafts, lengths: np.ndarray, k: int):
        """[S, K+1] verify windows: the committed token, then the candidates;
        columns >= length are bucket padding."""
        tok = np.zeros((self.num_slots, k + 1), np.int32)
        tok[:, 0] = self._tok[:, 0]
        for s in range(self.num_slots):
            if lengths[s] > 1:
                tok[s, 1 : lengths[s]] = drafts[s, : lengths[s] - 1]
        return tok

    def _spec_step(self, now: float, k: int, decoding) -> list[Request]:
        """Speculative decode for the decoding slots (DESIGN.md §11): the
        draft lane proposes K candidates per slot, the verify lane scores
        all K+1 positions in one target pass, and acceptance rewinds
        positions (and, paged, trims tables) as data. One packed pull per
        lane call (drafts, then ``pack_verify_d2h``'s ``[S, K+4]``); under
        async the verify pull parks and accept/rollback is replayed one step
        late (``_commit_spec``) — the next plan never needs the outcome, so
        nothing is guessed. The verify target's signature is the engine's
        (``_verify_call``)."""
        self._note_k_bucket(k)
        drafts = self._run_draft(k, decoding)
        lengths = np.array(
            [self._verify_len(s, k) for s in range(self.num_slots)], np.int32
        )
        tok = self._pack_verify_tok(drafts, lengths, k)
        t0_ns = time.perf_counter_ns()
        keys, packed = self._verify_call(k, tok, lengths)
        self._lane_tick(self._verify_lane, t0_ns)
        self.stats.verify_steps += 1
        self.stats.note_lane(self._verify_lane)
        self._mirror.put("keys", keys)
        rec = _InflightStep(kind="spec", packed=None, drafts=drafts,
                            lengths=lengths, k=k)
        if self.async_steps:
            rec.packed = self._stage_pull(packed)
            self._park(rec)
            return []
        return self._commit_spec(self._pull(packed), rec, now)

    def _apply_verify(self, now, rows, nxt0, drafts, lengths) -> list[Request]:
        """Accept/rollback as data: commit the accepted prefix plus the
        target's correction token, advance ``pos`` past it and feed the
        correction token next. Rejected-tail KV sits beyond the new
        position — masked by the per-row causal frontier and overwritten by
        the next committed write (paged storage also trims pages no window
        can reach, ``_after_commit``). A poisoned window (an emitted id
        below 0) quarantines its slot instead."""
        finished: list[Request] = []
        if self._faults is not None:
            nxt0, rows = self._inject_step_output(nxt0, rows)
        for s, req in enumerate(self._slots):
            if req is None or not self._active[s]:
                self.stats.idle_slot_steps += 1
                continue
            if self._prefilling[s]:
                continue  # the chunk lane owns this slot (ticked elsewhere)
            self.stats.active_slot_steps += 1
            ln = int(lengths[s])
            if ln == 0:
                continue
            prompt = req.effective_prompt
            if self._cursor[s] + 1 < len(prompt):
                # token-by-token forcing: row 0 wrote this prompt token's
                # KV; feed the next prompt token, drop the sample
                self._pos[s] += 1
                self._cursor[s] += 1
                self._tok[s, 0] = prompt[self._cursor[s]]
                self._after_commit(s, req)
                self.stats.prompt_tokens += 1
                continue
            self._before_emit(s, req)
            if ln == 1:
                emitted = [int(nxt0[s])]
            else:
                k_s = ln - 1
                a = self._accepted_prefix(drafts[s], rows[s], k_s)
                emitted = [int(t) for t in rows[s, : a + 1]]
                self.stats.drafted_tokens += k_s
                self.stats.accepted_tokens += a
                self.accept_samples.append(a / k_s)
                if self._trace is not None:
                    self._trace.emit(
                        "spec_rollback" if a < k_s else "spec_accept",
                        "lane:" + self._verify_lane,
                        args={"slot": s, "accepted": a, "k": k_s},
                    )
            if min(emitted) < 0:
                # NaN guard (§15): a poisoned sample surfaced as an invalid
                # token id. Quarantine exactly this slot — pos is not
                # advanced, nothing is appended, co-batched rows untouched.
                self._quarantine_slot(s, now)
                continue
            self._pos[s] += len(emitted)
            self._tok[s, 0] = emitted[-1]
            req.tokens.extend(emitted)
            self._after_commit(s, req)
            self._note_tokens(req, now)
            self.stats.tokens += len(emitted)
            if req.done:
                req.t_done = now
                self._note_finish(req, now)
                finished.append(req)
                self._release(s)
        self._mirror.touch("tok", "pos")
        return finished

    # ----------------------------------------------- storage hooks (dense)
    def _page_upkeep(self, k: int = 0) -> None:
        """Pre-step storage upkeep for the decoding slots' write windows."""

    def _sync_slot(self, s: int, pos: int) -> None:
        """The decode lane moved slot ``s`` to ``pos``; sync storage."""

    def _before_emit(self, s: int, req: Request) -> None:
        """Slot ``s`` is past its prompt and about to emit."""

    def _after_commit(self, s: int, req: Request) -> None:
        """Slot ``s``'s ``pos`` advanced in the verify lane."""

    def _release(self, s: int) -> None:
        """A request finished: its slot is free (its rows are masked out by
        the next occupant's position-0 join)."""
        self._slots[s] = None
        self._active[s] = False
        self._mirror.touch("active")
        self.stats.finished += 1

    # ------------------------------------- robustness surface (DESIGN.md §15)
    def _release_slot(self, s: int) -> None:
        """Storage-release hook for cancel/quarantine: clear the slot's
        host state and drop the device copies of its token and active bit,
        so the next step (a captured target's replay too) masks the row out
        (paged storage overrides to return the block table's pages too).
        The slot's input token is zeroed so a poisoned id never feeds a
        later gather."""
        self._slots[s] = None
        self._active[s] = False
        self._prefilling[s] = False
        self._tok[s, 0] = 0
        self._mirror.touch("tok", "active")

    def set_mesh(self, name: str, now: float = 0.0) -> str:
        """Cold-path topology rebind (DESIGN.md §16): move the live serving
        state onto another *warmed* mesh and flip the decode hot slot to
        its targets — ``set_knobs``'s twin on the key's mesh axis. The
        engine's ``mesh_ctl`` validates the name, copies the caches into
        the target mesh's captured buffers, moves the shared binding every
        dispatch closure reads and rebinds the dispatcher: a rebind, never
        a capture. Parked steps commit first; the device mirror drops its
        copies and the mesh-labelled lane histograms refresh. Returns the
        canonical name of the mesh now active (the current one: a
        no-op)."""
        if self._mesh_ctl is None:
            raise RuntimeError(
                "this batcher has no mesh control surface; construct it "
                "through Engine.continuous/paged_continuous with the "
                "target topology in EngineConfig.mesh/meshes."
            )
        if self._inflight:
            self._backlog.extend(self._commit_pending(now))
        nm, self._cache, self._draft_cache = self._mesh_ctl(
            name, self._cache, self._draft_cache, **self._mesh_hot()
        )
        if nm != self.mesh:
            self.mesh = nm
            leaf = self._cache[0]
            self.device = leaf[next(iter(leaf))].device
            self._mirror.invalidate(self.device)
            self._lane_hist = {}  # new handles carry the new mesh label
            self._rebind_step()
        return nm

    def _mesh_hot(self) -> dict:
        """The batcher's bucket state for ``mesh_ctl``'s hot key (the paged
        engine adds its pages bucket)."""
        return {}

    def _rebind_step(self) -> None:
        """Re-fetch a bound decode target under the new mesh binding (the
        paged engine dispatches per step and stores none)."""

    def attach_watchdog(self, watchdog, on_straggler=None) -> None:
        """Wire a ``ft.failover.StepTimeWatchdog`` into the step loop:
        every ``step()`` observes its wall time; a flagged straggler emits
        a flight-recorder event, counts in the registry, and calls
        ``on_straggler(dt_s)`` (the degradation controller's hook)."""
        self._watchdog = watchdog
        self._on_straggler = on_straggler

    def attach_faults(self, plan) -> None:
        """Arm a ``core.faults.FaultPlan`` at this batcher's injection
        sites (``step_output`` at the commit boundaries, ``d2h_stall`` in
        the pulls). Detection/containment report back through the plan."""
        self._faults = plan

    def _watchdog_tick(self, dt_s: float) -> None:
        straggler = self._watchdog.observe(self.stats.steps, dt_s)
        if straggler:
            self.stats.stragglers += 1
            self.telemetry.registry.inc("step_stragglers_total")
            if self._trace is not None:
                self._trace.emit(
                    "straggler", "scheduler",
                    args={"step": self.stats.steps,
                          "ms": round(dt_s * 1e3, 3)},
                )
            if self._stall_pending and self._faults is not None:
                # an injected d2h stall was caught by the watchdog: the
                # detection mechanism worked; containment is that the step
                # still committed (a latency fault kills no request)
                self._faults.note_detected("d2h_stall")
                self._faults.note_contained("d2h_stall")
            if self._on_straggler is not None:
                self._on_straggler(dt_s)
        self._stall_pending = False

    def set_knobs(
        self,
        *,
        spec_k: int | None = None,
        prefill_chunk: int | None = None,
        token_budget: int | None = None,
    ) -> dict:
        """Cold-path actuation surface for the degradation ladder (§15).

        Every knob is pure host data consumed by the per-step plan: the
        next step dispatches other *already-warmed* keys (smaller chunk
        buckets, smaller or no k-buckets), so an actuation is at most a
        rebind — never a build (on the card, never a capture). Values are
        clamped into the launch-time ranges warmup built; restoring the
        launch values is the symmetric recovery path."""
        if spec_k is not None:
            k = int(spec_k)
            k = 0 if k <= 0 else min(k, self._spec_max)
            if self._draft_dispatch is None or self._verify_dispatch is None:
                k = 0
            self.spec_k = k
            self._lane_policy.spec_k = k
        if prefill_chunk is not None and self._chunk_max > 0:
            self.prefill_chunk = bucket_pow2(
                max(CHUNK_BUCKET_MIN,
                    min(int(prefill_chunk), self._chunk_max)),
                CHUNK_BUCKET_MIN,
                self._chunk_max,
            )
        if token_budget is not None:
            b = min(self._budget_max,
                    max(int(token_budget), self.num_slots + 1))
            self.token_budget = b
            self._lane_policy.token_budget = b
        return {
            "spec_k": self.spec_k,
            "prefill_chunk": self.prefill_chunk,
            "token_budget": self.token_budget,
        }

    def cancel(self, rid: int, now: float = 0.0,
               reason: str = "cancel") -> bool:
        """Mid-stream cancellation: release the request's slot (and, paged,
        its pages), mark it cancelled, and account it. Every parked step
        commits first and its outcome is honoured — a request that finished
        inside that commit is *not* cancelled (commit-then-discard).
        Returns True when a seated request with ``rid`` was cancelled."""
        for s, req in enumerate(self._slots):
            if req is not None and req.rid == rid:
                return self._cancel_slot(s, now, reason) is not None
        return False

    def _cancel_slot(self, s: int, now: float, reason: str):
        target = self._slots[s]
        if self._inflight:
            # a parked step may be about to emit into this slot: commit
            # them all, then discard whatever landed (commit-then-discard)
            self._backlog.extend(self._commit_pending(now))
        req = self._slots[s]
        if req is None or req is not target:
            return None  # the committed step finished (or replaced) it
        req.cancelled = True
        req.shed_reason = reason
        self._release_slot(s)
        self.cancelled_requests.append(req)
        self.stats.cancelled += 1
        if reason == "deadline":
            self.stats.deadline_missed += 1
        self.telemetry.registry.inc(
            "requests_cancelled_total", reason=reason
        )
        if self._trace is not None:
            self._trace.emit("cancel", "scheduler",
                             args={"rid": req.rid, "slot": s,
                                   "reason": reason})
        return req

    def _cancel_overdue(self, now: float) -> None:
        """Deadline enforcement: cancel every seated request whose
        ``deadline_s`` has passed (runs once per step, only while some
        admitted request carried a deadline)."""
        for s in range(self.num_slots):
            req = self._slots[s]
            if (
                req is not None
                and req.deadline_s is not None
                and now > req.deadline_s
            ):
                self._cancel_slot(s, now, "deadline")

    def _quarantine_slot(self, s: int, now: float,
                         site: str = "step_output") -> None:
        """Fault containment (§15): a poisoned emission was detected on
        slot ``s``. Quarantine exactly that slot — release it (paged
        storage frees its pages) and either re-admit its request from
        scratch (first offence) or fail it (retry limit reached). The
        co-batched slots' state is untouched: per-row masking means the
        released row simply stops participating."""
        req = self._slots[s]
        self._release_slot(s)
        req.faults += 1
        self.stats.faults_detected += 1
        plan = self._faults
        if plan is not None:
            plan.note_detected(site)
        if self._trace is not None:
            self._trace.emit("quarantine", "scheduler",
                             args={"rid": req.rid, "slot": s, "site": site})
        if req.faults <= self._fault_retry_limit:
            # restart from scratch: poisoned progress is discarded, like a
            # preemption (the serving loop re-submits ``requeued``)
            req.tokens = []
            req.t_admit = None
            req.t_first = None
            req.t_last = None
            self.requeued.append(req)
            self.stats.faults_contained += 1
            if plan is not None:
                plan.note_contained(site)
        else:
            req.error = site
            self.failed_requests.append(req)
            self.stats.faults_failed += 1
            self.telemetry.registry.inc("requests_failed_total", site=site)

    def _inject_step_output(self, nxt_host, rows=None):
        """``step_output`` fault site: one commit boundary. When armed,
        replace the victim slot's emission with ``POISON_TOKEN`` (the
        int32 image of a NaN-poisoned sample). Only host copies are
        poisoned: a captured graph's static outputs and the async
        pipeline's pinned buffers are never written."""
        f = self._faults.fire("step_output")
        if f is None:
            return nxt_host, rows
        cands = [
            s for s, r in enumerate(self._slots)
            if r is not None and self._active[s] and not self._prefilling[s]
        ]
        if not cands:
            return nxt_host, rows
        s = cands[f.slot % len(cands)]
        nxt_host = np.array(nxt_host)
        nxt_host[s] = POISON_TOKEN
        if rows is not None:
            rows = np.array(rows)
            rows[s, :] = POISON_TOKEN
        if self._trace is not None:
            self._trace.emit("fault_inject", "scheduler",
                             args={"site": "step_output", "slot": s})
        return nxt_host, rows

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


class ContinuousBatcher(_MultiLaneMixin):
    """Slot-based continuous batching over the dense per-slot cache
    (DESIGN.md §4/§10/§11).

    ``step`` is the ``("cb", slots)`` branch target (``steps.
    make_slot_decode_fn``, bound by the engine): ``step(cache, tok, pos,
    active, temps, greedy, keys)``. The batcher owns the S slots' host
    state and the engine's dense cache, updated in place by every lane;
    ``admit`` (cold path) seats requests in free slots in ascending order,
    ``step`` (hot path) advances every slot with one direct call.

    A join resets the slot's position to 0: the per-row causal mask makes
    the previous occupant's rows invisible (``attention.decode_attention``).
    A leave clears the active bit. GREEDY vs SAMPLE is per-slot data.

    Prompts are ingested before generation. With ``prefill_dispatch`` and
    ``prefill_chunk`` set (DESIGN.md §10) a seated prompt rides the ``pfd``
    lane C tokens per step (PREFILL until its cursor reaches the prompt
    end, then DECODE); otherwise prompts are forced token by token through
    the decode step. With ``draft_dispatch``, ``verify_dispatch`` and
    ``draft_prefill_dispatch`` and ``spec_k > 0``, a step whose plan has
    k > 0 runs ``dr`` and ``vfd`` in place of ``cb``. ``async_steps``
    pipelines the steps (``_MultiLaneMixin.step``)."""

    def __init__(
        self,
        *,
        step: Callable,
        num_slots: int,
        max_len: int,
        cache: Any,
        device: torch.device | str = "cpu",
        seed: int = 0,
        prefill_dispatch: Callable[[int], Callable] | None = None,
        prefill_chunk: int = 0,
        telemetry: Telemetry | None = None,
        draft_dispatch: Callable[[int], Callable] | None = None,
        verify_dispatch: Callable[[int], Callable] | None = None,
        draft_prefill_dispatch: Callable[[int], Callable] | None = None,
        draft_cache: Any = None,
        spec_k: int = 0,
        async_steps: bool = False,
        async_depth: int = 2,
        storage: Any = None,
        token_budget: int = 0,
        mesh: str = "1x1",
        mesh_ctl: Callable | None = None,
        step_dispatch: Callable[[], Callable] | None = None,
    ):
        self.mesh = mesh  # before telemetry: lane histograms carry it
        self._mesh_ctl = mesh_ctl
        self._init_slots(num_slots, device, seed, telemetry)
        self._step = step
        self._step_dispatch = step_dispatch
        self.max_len = max_len
        self._cache = cache  # the engine's dense cache, updated in place
        self.stats = BatcherStats(registry=self.telemetry.registry)
        self._mirror = _DeviceMirror(self.stats, self.device)
        self._init_lanes(
            prefill_dispatch=prefill_dispatch,
            prefill_chunk=prefill_chunk,
            draft_dispatch=draft_dispatch,
            verify_dispatch=verify_dispatch,
            draft_prefill_dispatch=draft_prefill_dispatch,
            draft_cache=draft_cache,
            spec_k=spec_k,
            async_steps=async_steps,
            async_depth=async_depth,
            storage=storage,
            token_budget=token_budget,
        )

    def _rebind_step(self) -> None:
        """The dense batcher holds its decode target bound; after a mesh
        flip the engine's closure fetches the new mesh's (``mesh_ctl``'s
        ``set_direction`` already flipped the hot slot: a table read)."""
        if self._step_dispatch is not None:
            self._step = self._step_dispatch()

    # ------------------------------------------------------------- cold path
    def admit(self, requests: Iterable[Request], now: float = 0.0) -> int:
        """Seat requests in free slots, ascending; returns the number
        admitted. A request whose prompt and tokens cannot fit ``max_len``
        raises ``ValueError``. Each seated request draws its slot's key."""
        requests = list(requests)
        if requests and self._inflight:
            # admission edits the per-slot state and re-uploads it: the
            # parked steps land first, so those arrays are current
            self._backlog.extend(self._commit_pending(now))
        admitted = 0
        free = [i for i, r in enumerate(self._slots) if r is None]
        for req in requests:
            if not free:
                raise RuntimeError(
                    "ContinuousBatcher.admit called with no free slot; "
                    "gate admissions on .free_slots."
                )
            prompt = req.effective_prompt
            if len(prompt) + req.new_tokens - 1 > self.max_len:
                raise ValueError(
                    f"request {req.rid} wants {len(prompt)} prompt + "
                    f"{req.new_tokens} new tokens but the cache holds "
                    f"max_len={self.max_len}."
                )
            s = free.pop(0)  # ascending slot order (deterministic)
            self._slots[s] = req
            self._tok[s, 0] = prompt[0]
            self._pos[s] = 0
            self._cursor[s] = 0
            self._active[s] = True
            # PREFILL when there is a prompt to ingest and a chunked lane
            # to ingest it with; single-seed requests decode straight away
            self._prefilling[s] = self.prefill_chunk > 0 and len(prompt) > 1
            self._temps[s] = req.temperature
            self._greedy[s] = req.greedy
            self._keys[s] = self._draw_keys(2)
            req.t_admit = now
            if req.deadline_s is not None:
                self._has_deadlines = True
            self._note_admit(req, now)
            admitted += 1
        if admitted:
            self._mirror.touch("tok", "pos", "active", "temps", "greedy",
                               "keys")
            if self.async_steps:  # stage them on the cold path
                self._preload_step_inputs()
        self.stats.admitted += admitted
        return admitted

    # ------------------------------------------------------- prefill lane
    def _prefill_step(self, now: float, budget: int) -> list[Request]:
        """Ingest chunks for prefilling requests, batched (DESIGN.md §10):
        every planned chunk rides one ``("pfd", slots, chunk_bucket)`` call,
        written straight into its slot's rows (length 0 = idle row). The
        flip (prompt done) primes generation with the chunk's last-row
        sample. A chunk that flips no slot parks under async
        (``_park_prefill``)."""
        plan = self._plan_chunks(budget)
        if not plan:
            return []
        bucket = self._chunk_bucket_for(plan)
        step = self._prefill_dispatch(bucket)  # cold: slot-hit usually
        ins = _static_inputs(step)
        tok = np.zeros((self.num_slots, bucket), np.int32)
        length = np.zeros(self.num_slots, np.int32)
        for s, cursor, chunk in plan:
            prompt = self._slots[s].effective_prompt
            tok[s, :chunk] = prompt[cursor : cursor + chunk]
            length[s] = chunk
        park = self._parks(plan)
        # chunk inputs are per-chunk data, uploaded raw (the keys too,
        # unless a parked predecessor's split is still on the device)
        self.stats.prefill_calls += 1
        self.stats.note_lane(self._prefill_lane)
        self.stats.h2d_uploads += 3 if park else 4
        tok_dev = self._upload(tok, ins[0])
        start_dev = self._upload(self._pos, ins[1])  # == cursor: prefilling
        length_dev = self._upload(length, ins[2])
        keys_dev = (self._mirror.get("keys", self._keys_i32, ins[5]) if park
                    else self._upload(self._keys_i32, ins[5]))
        t0_ns = time.perf_counter_ns()
        nxt, self._cache, new_keys, packed = step(
            self._cache, tok_dev, start_dev, length_dev,
            self._mirror.get("temps", self._temps, ins[3]),
            self._mirror.get("greedy", self._greedy, ins[4]),
            keys_dev,
        )
        self._lane_tick(self._prefill_lane, t0_ns)
        if park:
            self._park_prefill(plan, new_keys, packed)
            return []
        # pulled before the draft mirror's call: with graphs, packed is a
        # static output that another replay in the pool may overwrite
        p = self._pull(packed)  # [S,3]: sample | keys
        nxt_host, nk = p[:, 0], p[:, 1:3].astype(np.uint32)
        self._mirror_draft_prompt(bucket, tok_dev, start_dev, length_dev,
                                  keys_dev)
        finished: list[Request] = []
        for s, cursor, chunk in plan:
            req = self._slots[s]
            self._keys[s] = nk[s]
            self._chunk_slots.add(s)
            cursor += chunk
            self._cursor[s] = cursor
            self._pos[s] = cursor
            self.stats.prompt_tokens += chunk
            self.stats.prefill_chunks += 1
            if cursor >= len(req.effective_prompt):  # flip: prime generation
                self._prime_first_token(s, req, int(nxt_host[s]), now)
                if req.done:  # new_tokens == 1: the primed token was last
                    req.t_done = now
                    self._note_finish(req, now)
                    finished.append(req)
                    self._release(s)
        self._mirror.touch("pos", "keys")
        return finished

    # -------------------------------------------------------------- hot path
    def _decode_lane_step(self, now: float, decoding) -> list[Request]:
        """The ``cb`` lane: one direct call of the bound target, one packed
        pull (or, under async, a parked step)."""
        step = self._step
        ins = _static_inputs(step)
        t0_ns = time.perf_counter_ns()
        out = step(
            self._cache,
            self._mirror.get("tok", self._tok, ins[0]),
            self._mirror.get("pos", self._pos, ins[1]),
            self._mirror.get("active", decoding, ins[2]),
            self._mirror.get("temps", self._temps, ins[3]),
            self._mirror.get("greedy", self._greedy, ins[4]),
            self._mirror.get("keys", self._keys_i32, ins[5]),
        )
        return self._commit_decode(t0_ns, out, decoding, now)

    def _verify_call(self, k: int, tok: np.ndarray, lengths: np.ndarray):
        """The dense verify target ``("vfd", slots, k)``: the windows start
        at each slot's position. Returns the new keys (chained) and the
        packed ``[S, K+4]`` device tensor."""
        step = self._verify_dispatch(k)  # cold: slot-hit unless k moved
        ins = _static_inputs(step)
        self.stats.h2d_uploads += 2  # per-step window data (tokens, lengths)
        _, _, self._cache, keys, packed = step(
            self._cache,
            self._upload(tok, ins[0]),
            self._mirror.get("pos", self._pos, ins[1]),
            self._upload(lengths, ins[2]),
            self._mirror.get("temps", self._temps, ins[3]),
            self._mirror.get("greedy", self._greedy, ins[4]),
            self._mirror.get("keys", self._keys_i32, ins[5]),
        )
        return keys, packed


class PagedContinuousBatcher(_MultiLaneMixin):
    """Continuous batching against a paged KV pool (DESIGN.md §9/§10/§11).

    Each seated request owns a ``kvcache.BlockTable`` over the shared
    ``PagePool``; the decode lane's key is ``("cbp", slots, pages_bucket,
    kv_dtype)`` where ``pages_bucket`` is the (bucketed) widest table of a
    decoding slot, and the prefill lane's is ``("pf", slots, chunk_bucket,
    kv_dtype)``. ``dispatch_fn(bucket)`` / ``prefill_dispatch(bucket)``
    return the branch target for a bucket (the engine's dispatcher); the
    step loop calls it directly. With ``draft_dispatch(k)``,
    ``verify_dispatch(k)`` and ``draft_prefill_dispatch(bucket)`` supplied
    and ``spec_k > 0``, a step whose plan has k > 0 runs the draft and
    verify lanes instead of the decode lane (draft pull, verify pull,
    accept/rollback; under ``async_steps`` the verify commit lags a step).

    Admission walks the ``PrefixCache``: prompt pages already populated by
    an earlier request are adopted by reference, the ingestion cursor starts
    after them, and completed prompts insert their full pages back. On pool
    exhaustion idle cached pages are evicted first, then the lowest-priority
    active request is preempted (its pages recycle; it re-queues and
    restarts) — admission never hard-rejects a request that can fit.

    Disaggregated (DESIGN.md §17; the engine passes ``pf_pool``,
    ``pf_cache``, ``transport`` and ``disagg_ctl``), a prefilling slot
    writes a shadow block table in the prefill slice's own pool: its
    adopted prefix pages are copied there at admission, its chunks run on
    the prefill slice, and at the PREFILL -> DECODE flip its fresh pages
    migrate to the decode pool (``kvcache.migrate_pages`` for the ids, the
    ``mg`` targets for the contents) before the prompt is published to the
    prefix trie. ``set_disagg`` splits or collapses mid-stream.
    """

    _decode_lane = "cbp"
    _prefill_lane = "pf"
    _verify_lane = "vf"

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
        draft_dispatch: Callable[[int], Callable] | None = None,
        verify_dispatch: Callable[[int], Callable] | None = None,
        draft_prefill_dispatch: Callable[[int], Callable] | None = None,
        draft_cache: Any = None,
        spec_k: int = 0,
        async_steps: bool = False,
        async_depth: int = 2,
        storage: Any = None,
        token_budget: int = 0,
        mesh: str = "1x1",
        mesh_ctl: Callable | None = None,
        pf_pool=None,
        pf_cache: Any = None,
        pf_device: torch.device | str | None = None,
        transport: Callable | None = None,
        disagg_ctl: Callable | None = None,
        disagg: bool = False,
    ):
        if pool.shards > num_slots:
            raise ValueError(
                f"pool has {pool.shards} shards but only {num_slots} slots; "
                f"every shard needs at least one slot to serve its pages."
            )
        self.mesh = mesh  # before telemetry: lane histograms carry it
        self._mesh_ctl = mesh_ctl
        self._init_slots(num_slots, device, seed, telemetry)
        self._dispatch = dispatch_fn
        self.pool = pool
        self.prefix = prefix_cache
        self._cache = cache  # pooled device pages, updated in place by steps
        self.max_pages_per_req = max_pages_per_req
        # device half of COW: cache_copy(cache, src, dst) -> cache
        self._cache_copy = cache_copy
        self._tables: list[BlockTable | None] = [None] * num_slots
        self._prompt_cached = np.zeros(num_slots, bool)
        self._pages_bucket = 1
        # Data-parallel slot partitioning (DESIGN.md §16): slot ``s`` is
        # pinned to pool shard ``s * shards // num_slots`` (contiguous slot
        # groups per shard), so its table allocates, adopts and
        # prefix-matches only that shard's pages; one shard makes every
        # entry 0, the unsharded layout. Packed tables pad each row with
        # its own shard's null page (zeros with one shard).
        self._slot_shard = [s * pool.shards // num_slots
                            for s in range(num_slots)]
        self._null_fill = np.array(
            [pool.null_page(sh) for sh in self._slot_shard], np.int32)
        self._bt_host: np.ndarray | None = None
        self._bt_dirty = True  # packed decode tables need a rebuild
        # full-width packed tables for the verify lane (pinned at the page
        # cap, like the prefill lane's: k is the only verify bucket axis)
        self._bt_full: np.ndarray | None = None
        self._bt_full_dirty = True
        self.preempted: list[Request] = []
        self.rejected: list[Request] = []  # oversized: can never be seated
        self._starved_rids: set[int] = set()
        # Disaggregated prefill/decode (DESIGN.md §17): the prefill slice's
        # pool and cache, the page transport and the split/collapse rebind
        # (engine-wired; None without ``disagg``). ``self.disagg`` is the
        # current mode. Per slot: the shadow table a prefilling slot writes
        # on the prefill slice, and how many of its leading pages are copies
        # of decode-resident pages (dropped, not migrated, at the flip).
        self.pf_pool = pf_pool
        self._pf_cache = pf_cache
        self._pf_device = torch.device(pf_device or self.device)
        self._transport = transport
        self._pf_staged: dict[str, tuple[np.ndarray, torch.Tensor]] = {}
        self._disagg_ctl = disagg_ctl
        self.disagg = bool(disagg) and disagg_ctl is not None
        self._pf_tables: dict[int, BlockTable] = {}
        self._pf_keep: dict[int, int] = {}
        self.stats = PagedBatcherStats(registry=self.telemetry.registry)
        self._mirror = _DeviceMirror(self.stats, self.device)
        self._init_lanes(
            prefill_dispatch=prefill_dispatch,
            prefill_chunk=prefill_chunk,
            draft_dispatch=draft_dispatch,
            verify_dispatch=verify_dispatch,
            draft_prefill_dispatch=draft_prefill_dispatch,
            draft_cache=draft_cache,
            spec_k=spec_k,
            async_steps=async_steps,
            async_depth=async_depth,
            storage=storage,
            token_budget=token_budget,
        )

    # ------------------------------------------------------------ properties
    @property
    def pages_bucket(self) -> int:
        return self._pages_bucket

    @property
    def kv_dtype(self) -> str:
        """The pool's page storage dtype (DESIGN.md §12), fixed per batcher."""
        return self.pool.kv_dtype

    def _tables_changed(self) -> None:
        """Some block table changed shape or contents (growth, COW, trim,
        admit, release): both packed host tables need a rebuild."""
        self._bt_dirty = True
        self._bt_full_dirty = True

    def live_tables(self):
        return [t for t in self._tables if t is not None]

    def _mesh_hot(self) -> dict:
        """The paged decode key carries the pages bucket: ``mesh_ctl``
        flips the hot slot to the same bucket on the new mesh."""
        return {"pages_bucket": self._pages_bucket}

    def _preload_step_inputs(self) -> None:
        super()._preload_step_inputs()
        if not self._bt_dirty and self._bt_host is not None:
            self._mirror.preload("bt", self._bt_host)

    def _pre_issue_fast(self) -> None:
        """Run-ahead needs the decode write windows' pages (growth, COW)
        before the next step issues; ``self._pos`` is the predicted
        frontier, exactly the position that step writes."""
        self._page_upkeep(0)

    # ------------------------------------------------------------- cold path
    def _reclaim_pages(self, want: int, requester_priority: int,
                       shard: int = 0) -> bool:
        """Free >= ``want`` pages *on ``shard``*: evict idle prefix pages
        from that shard's trie, then preempt strictly-lower-priority
        requests seated on the same shard (a victim elsewhere would free
        the wrong shard's pages). False if pressure can't be met."""
        if self.pool.pages_free_in(shard) >= want:
            return True
        self.prefix.evict(want - self.pool.pages_free_in(shard), shard)
        while self.pool.pages_free_in(shard) < want:
            victim = self._pick_victim(requester_priority, shard)
            if victim is None:
                return False
            self._preempt_slot(victim)
            self.prefix.evict(want - self.pool.pages_free_in(shard), shard)
        return True

    def _pick_victim(self, requester_priority: int,
                     shard: int = 0) -> int | None:
        """Lowest-priority active slot strictly below the requester *on the
        requester's shard*; ties break toward the most recently admitted
        (least sunk work)."""
        best, best_key = None, None
        for s, req in enumerate(self._slots):
            if req is None or not self._active[s]:
                continue
            if self._slot_shard[s] != shard:
                continue
            if req.priority >= requester_priority:
                continue
            key = (req.priority, -(req.t_admit or 0.0))
            if best_key is None or key < best_key:
                best, best_key = s, key
        return best

    def _preempt_slot(self, s: int) -> None:
        req = self._slots[s]
        self._drop_pf_state(s)
        self._tables[s].release()
        self._tables[s] = None
        self._slots[s] = None
        self._active[s] = False
        self._prefilling[s] = False
        self._mirror.touch("active")
        self._tables_changed()
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
        request that can fit). Each seated request draws its slot's key."""
        requests = list(requests)
        if requests and self._inflight:
            # admission edits the per-slot state and re-uploads it: the
            # parked steps land first, so those arrays are current
            self._backlog.extend(self._commit_pending(now))
        deferred: list[Request] = []
        seated = False
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
            # The request seats in the head free slot, and the slot pins the
            # pool shard, so the shard is decided before the prefix walk:
            # only pages resident on that shard may be adopted.
            s = free[0]
            shard = self._slot_shard[s]
            # Prefix-cache walk: adopt already-populated full prompt pages,
            # but never the page holding the last prompt token — that token
            # is re-fed to prime generation, and keeping its page private
            # makes prompt-path writes COW-free.
            pages, _ = self.prefix.match(prompt, shard)
            usable = min(len(pages), (len(prompt) - 1) // self.pool.page_size)
            for pid in pages[usable:]:
                self.pool.decref(pid)
            pages = pages[:usable]
            matched = usable * self.pool.page_size
            table = BlockTable(pool=self.pool, pages=pages, num_tokens=matched,
                               shard=shard)
            # first private page: the one the re-fed prompt token writes into
            starved = not self._reclaim_pages(1, req.priority, shard) or (
                not table.ensure_capacity(matched)
            )
            # PREFILL when more than the re-fed last token remains to ingest
            # and a chunked lane exists; otherwise straight to DECODE
            # (token-by-token forcing handles any prompt remainder there)
            will_prefill = self.prefill_chunk > 0 and len(prompt) - matched > 1
            if not starved and self.disagg and will_prefill:
                # disaggregated chunks run on the prefill slice: copy the
                # adopted prefix pages there, and drop the just-ensured
                # private decode page (every page the prefill lane writes
                # reaches the decode pool by migration at the flip)
                if self._make_pf_shadow(s, table):
                    table.trim(len(pages))
                else:
                    starved = True
            if starved:
                table.release()
                if req.rid not in self._starved_rids:  # count requests once
                    self._starved_rids.add(req.rid)
                    self.stats.starved_admissions += 1
                deferred.append(req)
                continue
            free.pop(0)  # == s, peeked above
            self._slots[s] = req
            self._tables[s] = table
            self._cursor[s] = matched
            self._tok[s, 0] = prompt[matched]
            self._pos[s] = matched
            self._active[s] = True
            self._prefilling[s] = will_prefill
            self._temps[s] = req.temperature
            self._greedy[s] = req.greedy
            self._keys[s] = self._draw_keys(2)
            self._prompt_cached[s] = False
            req.t_admit = now
            if req.deadline_s is not None:
                self._has_deadlines = True
            self._note_admit(req, now)
            self._mirror.touch("tok", "pos", "active", "temps", "greedy",
                               "keys")
            self._tables_changed()
            self.stats.admitted += 1
            self.stats.shared_tokens += matched
            seated = True
        if seated and self.async_steps:  # stage them on the cold path
            self._preload_step_inputs()
        return deferred

    def _page_upkeep(self, k: int = 0) -> None:
        """Pre-step cold path: every decoding slot must own writable pages
        for its whole write window this step — its current position for the
        decode lane, ``[pos, pos + len - 1]`` for a verify window of ``len``
        (DESIGN.md §11). Growth/COW happens here, never in-loop; the prefill
        lane reserves its own chunk's pages."""
        ps = self.pool.page_size
        for s, req in enumerate(self._slots):
            if req is None or not self._active[s] or self._prefilling[s]:
                continue
            table = self._tables[s]
            pos = int(self._pos[s])
            top = pos + max(self._verify_len(s, k) - 1, 0) if k > 0 else pos
            need = table.page_index(top) + 1 - table.num_pages
            if need > 0:
                self._tables_changed()
                if not self._reclaim_pages(need, req.priority, table.shard) or (
                    not table.ensure_capacity(top)
                ):
                    self._preempt_slot(s)  # can't grow: preempt the requester
                    continue
            for pi in range(table.page_index(pos), table.page_index(top) + 1):
                if not table.ensure_writable(
                    max(pos, pi * ps), self._device_copy_page
                ):
                    self._preempt_slot(s)
                    break

    def _device_copy_page(self, src: int, dst: int) -> None:
        self._tables_changed()  # COW swapped a page id in some table
        self._cache = self._cache_copy(self._cache, src, dst)

    # ----------------------------- disaggregated prefill/decode (§17)
    def _pf_stage(self, name: str, host: np.ndarray) -> torch.Tensor:
        """Upload ``host`` to the prefill slice, memoised by content: the
        per-slot sampling state changes rarely between chunk steps, so the
        steady state uploads nothing new."""
        hit = self._pf_staged.get(name)
        if hit is not None and np.array_equal(hit[0], host):
            return hit[1]
        dev = _upload(host, self._pf_device)
        self._pf_staged[name] = (np.array(host, copy=True), dev)
        self.stats.h2d_uploads += 1
        return dev

    def _make_pf_shadow(self, s: int, table: BlockTable, n: int | None = None,
                        keep: int | None = None) -> bool:
        """Give slot ``s`` a prefill-slice shadow of the first ``n`` pages
        of its decode-side ``table`` (default: its full adopted prefix
        pages): twins in the prefill pool, their contents copied across, so
        the chunk steps attend the prefix without touching the decode
        slice. ``keep`` of the leading shadow pages are never written on
        the prefill slice and are dropped, not migrated, at the flip
        (default all ``n``; a mid-prefill split passes fewer: its partly
        written boundary page keeps being written there). False = the
        prefill pool is dry."""
        if n is None:
            n = table.num_tokens // self.pool.page_size
        if keep is None:
            keep = n
        shard = table.shard
        pages: list[int] = []
        for _ in range(n):
            pid = self.pf_pool.alloc(shard)
            if pid is None:
                for p in pages:
                    self.pf_pool.decref(p)
                return False
            pages.append(pid)
        if pages:
            self._transport(self._cache, self._pf_cache, table.pages[:n],
                            pages, to_prefill=True)
        self._pf_tables[s] = BlockTable(
            pool=self.pf_pool, pages=pages, num_tokens=table.num_tokens,
            shard=shard,
        )
        self._pf_keep[s] = keep
        self.stats.pf_shadow_pages += n
        return True

    def _migrate_back(self, s: int) -> bool:
        """Land slot ``s``'s freshly written prefill-slice pages in the
        decode pool and fold them into its table: the KV handoff of the
        PREFILL -> DECODE flip (and of a collapse). The ids move by
        ``kvcache.migrate_pages`` (refcounts conserved), the contents by the
        engine's transport. The leading ``_pf_keep`` shadow pages copy
        pages the table still holds and are dropped; a partly written
        boundary page (a mid-prefill split) migrates back and replaces its
        stale decode twin (``trim``). False = the decode pool could not
        take the pages and the slot was preempted."""
        pf_t = self._pf_tables.pop(s)
        keep = self._pf_keep.pop(s, 0)
        base = self._tables[s]
        req = self._slots[s]
        fresh = pf_t.pages[keep:]
        if fresh:
            shard = base.shard
            if not self._reclaim_pages(len(fresh), req.priority, shard):
                pf_t.release()
                self._preempt_slot(s)
                return False
            mapping = migrate_pages(self.pf_pool, self.pool, fresh, shard)
            dst = [mapping[p] for p in fresh]
            self._transport(self._pf_cache, self._cache, fresh, dst)
            base.trim(keep)  # the stale twin of the boundary page, if any
            base.pages.extend(dst)  # the import carried the refcounts
            self.stats.migrations += 1
            self.stats.migrated_pages += len(fresh)
            # the exported ids already left the prefill pool: drop them
            # without a decref, so release() returns only the kept shadows
            del pf_t.pages[keep:]
        base.num_tokens = int(self._cursor[s])
        pf_t.release()
        self._tables_changed()
        return True

    def _drop_pf_state(self, s: int) -> None:
        """Slot ``s`` is leaving (preempt, cancel, finish): return its
        prefill-slice shadow pages, if it still holds any."""
        pf_t = self._pf_tables.pop(s, None)
        if pf_t is not None:
            pf_t.release()
        self._pf_keep.pop(s, None)

    def set_disagg(self, on: bool, now: float = 0.0) -> bool:
        """Cold-path split/collapse (DESIGN.md §17): switch between
        disaggregated prefill/decode and shared-mesh serving mid-stream.
        Both prefill bindings are warmed, so — like ``set_mesh`` and
        ``set_knobs`` — this is a rebind, never a capture; the decode lane's
        binding never moves. Parked steps commit first. Splitting gives
        every mid-prefill slot a shadow of its written pages on the
        prefill slice (its next chunk runs there); collapsing migrates the
        fresh prefill-slice pages back and prefill continues on the decode
        mesh. Returns the mode now active."""
        if self._disagg_ctl is None:
            raise RuntimeError(
                "this batcher has no disaggregation surface; construct it "
                "through Engine.paged_continuous(disagg=...)."
            )
        on = bool(on)
        if on == self.disagg:
            return on
        if self._inflight:
            self._backlog.extend(self._commit_pending(now))
        ps = self.pool.page_size
        if on:
            for s, req in enumerate(self._slots):
                if req is None or not self._active[s] or not self._prefilling[s]:
                    continue
                table = self._tables[s]
                if not self._make_pf_shadow(s, table, n=table.num_pages,
                                            keep=table.num_tokens // ps):
                    self._preempt_slot(s)  # the prefill slice can't hold it
        else:
            for s in list(self._pf_tables):
                if s in self._pf_tables:  # a reclaim may have preempted it
                    self._migrate_back(s)
        self.disagg = on
        self._lane_policy.decoupled = on
        self._disagg_ctl(on)
        if self._trace is not None:
            self._trace.emit("disagg_flip", "scheduler", args={"on": on})
        return on

    # ------------------------------------------------------- prefill lane
    def _prefill_step(self, now: float, budget: int) -> list[Request]:
        """Ingest chunks for prefilling requests, batched (DESIGN.md §10):
        every planned chunk's pages are reserved first (reclaim, else
        preempt the requester), then every surviving slot rides one
        ``("pf", slots, chunk_bucket)`` call — per-row chunk
        windows through per-row block tables, length 0 = idle row, padded
        columns writing only the null page. The flip (prompt done) publishes
        the prompt's full pages to the prefix cache and primes generation
        with the chunk's last-row sample. Disaggregated, the call runs on
        the prefill slice over the slots' shadow tables, and a flip first
        migrates the prompt's pages to the decode pool."""
        plan = self._plan_chunks(budget)
        for s, cursor, chunk in plan:
            req = self._slots[s]
            if req is None or not self._active[s] or not self._prefilling[s]:
                continue  # a victim of an earlier reservation's preemption
            table = self._pf_tables[s] if self.disagg else self._tables[s]
            need = table.page_index(cursor + chunk - 1) + 1 - table.num_pages
            if need <= 0:
                continue
            if self.disagg:
                # prefill-slice growth draws on the prefill pool alone: it
                # has no trie to evict and no decode tenants to preempt
                if not table.ensure_capacity(cursor + chunk - 1):
                    self._preempt_slot(s)
                continue
            self._tables_changed()
            if not self._reclaim_pages(need, req.priority, table.shard) or (
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
        bucket = self._chunk_bucket_for(kept)
        step = self._prefill_dispatch(bucket)
        ins = _static_inputs(step)
        tok = np.zeros((self.num_slots, bucket), np.int32)
        length = np.zeros(self.num_slots, np.int32)
        # idle rows pad with each slot's own shard's null page, so padded
        # writes stay in the slot's shard under a data-parallel mesh
        bt = np.repeat(self._null_fill[:, None], self.max_pages_per_req, 1)
        for s, cursor, chunk in kept:
            prompt = self._slots[s].effective_prompt
            tok[s, :chunk] = prompt[cursor : cursor + chunk]
            length[s] = chunk
            table = self._pf_tables[s] if self.disagg else self._tables[s]
            bt[s, : table.num_pages] = table.pages
        park = self._parks(kept)
        # chunk inputs are per-chunk data, uploaded raw (the keys too,
        # unless a parked predecessor's split is still on the device)
        self.stats.prefill_calls += 1
        self.stats.note_lane(self._prefill_lane)
        if self.disagg:
            # straight to the prefill slice; the slow-moving sampling state
            # is staged there and uploaded again only when it changes
            dev = self._pf_device
            self.stats.h2d_uploads += 5
            tok_dev = _upload(tok, dev, ins[0])
            start_dev = _upload(self._pos, dev, ins[1])
            bt_dev = _upload(bt, dev, ins[2])
            length_dev = _upload(length, dev, ins[3])
            temps_dev = self._pf_stage("temps", self._temps)
            greedy_dev = self._pf_stage("greedy", self._greedy)
            keys_dev = _upload(self._keys_i32, dev, ins[6])
            cache_in = self._pf_cache
        else:
            self.stats.h2d_uploads += 4 if park else 5
            tok_dev = self._upload(tok, ins[0])
            start_dev = self._upload(self._pos, ins[1])
            bt_dev = self._upload(bt, ins[2])
            length_dev = self._upload(length, ins[3])
            temps_dev = self._mirror.get("temps", self._temps, ins[4])
            greedy_dev = self._mirror.get("greedy", self._greedy, ins[5])
            keys_dev = (self._mirror.get("keys", self._keys_i32, ins[6])
                        if park else self._upload(self._keys_i32, ins[6]))
            cache_in = self._cache
        t0_ns = time.perf_counter_ns()
        nxt, cache_out, new_keys, packed = step(
            cache_in, tok_dev, start_dev, bt_dev, length_dev, temps_dev,
            greedy_dev, keys_dev,
        )
        if not self.disagg:  # the prefill slice's pool is updated in place
            self._cache = cache_out
        self._lane_tick(self._prefill_lane, t0_ns)
        if park:
            self._park_prefill(kept, new_keys, packed)
            return []
        # pulled before the draft mirror's call: with graphs, packed is a
        # static output that another replay in the pool may overwrite
        p = self._pull(packed)  # [S,3]: sample | keys
        nxt_host, nk = p[:, 0], p[:, 1:3].astype(np.uint32)
        # Prefix-cache-adopted pages never pass through the draft mirror, so
        # the draft's view of a shared prefix stays cold: acceptance drops
        # on those requests, correctness never does.
        self._mirror_draft_prompt(bucket, tok_dev, start_dev, length_dev,
                                  keys_dev)
        finished: list[Request] = []
        for s, cursor, chunk in kept:
            req = self._slots[s]
            prompt = req.effective_prompt
            self._keys[s] = nk[s]
            self._chunk_slots.add(s)
            cursor += chunk
            self._cursor[s] = cursor
            self._pos[s] = cursor
            # disaggregated, the shadow tracks the written frontier and the
            # decode table catches up at the flip's migration
            (self._pf_tables[s] if self.disagg
             else self._tables[s]).num_tokens = cursor
            self.stats.prompt_tokens += chunk
            self.stats.prefill_chunks += 1
            if cursor >= len(prompt):  # flip: prompt done, prime generation
                if self.disagg and not self._migrate_back(s):
                    continue  # the decode pool balked: the slot was preempted
                self._tables_changed()  # the decode tables gain this row
                self._before_emit(s, req)  # publish the prompt's full pages
                self._prime_first_token(s, req, int(nxt_host[s]), now)
                if req.done:  # new_tokens == 1: the primed token was last
                    req.t_done = now
                    self._note_finish(req, now)
                    self._release(s)
                    finished.append(req)
        self._mirror.touch("pos", "keys")
        return finished

    # -------------------------------------------------------------- hot path
    def _decode_lane_step(self, now: float, decoding) -> list[Request]:
        """Capacity-bucket dispatch, packed block tables, one direct step
        call, one packed pull (or, under async, a parked step)."""
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
            self._tables_changed()  # table width changed
        step = self._dispatch(bucket)  # cold: slot-hit unless bucket moved
        ins = _static_inputs(step)
        if self._bt_dirty:
            bt = np.repeat(self._null_fill[:, None], bucket, 1)  # null pages
            for s, table in enumerate(self._tables):
                if table is not None and decoding[s]:
                    bt[s, : table.num_pages] = table.pages
            self._bt_host = bt
            self._bt_dirty = False
            self._mirror.touch("bt")
        t0_ns = time.perf_counter_ns()
        out = step(
            self._cache,
            self._mirror.get("tok", self._tok, ins[0]),
            self._mirror.get("pos", self._pos, ins[1]),
            self._mirror.get("bt", self._bt_host, ins[2]),
            self._mirror.get("active", decoding, ins[3]),
            self._mirror.get("temps", self._temps, ins[4]),
            self._mirror.get("greedy", self._greedy, ins[5]),
            self._mirror.get("keys", self._keys_i32, ins[6]),
        )
        return self._commit_decode(t0_ns, out, decoding, now)

    def _sync_slot(self, s: int, pos: int) -> None:
        self._tables[s].num_tokens = pos

    def _release(self, s: int) -> None:
        """A request finished: its pages return to the pool."""
        self._drop_pf_state(s)
        self._tables[s].release()
        self._tables[s] = None
        self._tables_changed()
        super()._release(s)

    def _release_slot(self, s: int) -> None:
        """Cancel/quarantine release for paged storage: the slot's block
        table returns its pages to the pool before the host state clears,
        and the packed tables are rebuilt, so no later replay reads a
        freed page."""
        self._drop_pf_state(s)
        if self._tables[s] is not None:
            self._tables[s].release()
            self._tables[s] = None
        super()._release_slot(s)
        self._tables_changed()

    # ---------------------------------------------------- draft/verify lanes
    def _verify_call(self, k: int, tok: np.ndarray, lengths: np.ndarray):
        """The paged verify target ``("vf", slots, k, kv_dtype)`` with the
        full-width packed tables (rebuilt only when a table changed);
        ``_page_upkeep(k)`` already reserved and COW'd every page of the
        windows. Returns the new keys (chained) and the packed ``[S, K+4]``
        device tensor."""
        if self._bt_full_dirty:
            bt = np.repeat(self._null_fill[:, None], self.max_pages_per_req, 1)
            for s, table in enumerate(self._tables):
                if table is not None:
                    bt[s, : table.num_pages] = table.pages
            self._bt_full = bt
            self._bt_full_dirty = False
            self._mirror.touch("bt_full")
        step = self._verify_dispatch(k)  # cold: slot-hit unless k moved
        ins = _static_inputs(step)
        self.stats.h2d_uploads += 2  # per-step window data (tokens, lengths)
        _, _, self._cache, keys, packed = step(
            self._cache,
            self._upload(tok, ins[0]),
            self._mirror.get("pos", self._pos, ins[1]),
            self._mirror.get("bt_full", self._bt_full, ins[2]),
            self._upload(lengths, ins[3]),
            self._mirror.get("temps", self._temps, ins[4]),
            self._mirror.get("greedy", self._greedy, ins[5]),
            self._mirror.get("keys", self._keys_i32, ins[6]),
        )
        return keys, packed

    def _before_emit(self, s: int, req: Request) -> None:
        """Prompt fully written: publish its full pages for sharing."""
        if not self._prompt_cached[s]:
            prompt = req.effective_prompt
            full = len(prompt) // self.pool.page_size
            if full > 0:
                self.prefix.insert(prompt, self._tables[s].pages[:full])
            self._prompt_cached[s] = True

    def _after_commit(self, s: int, req: Request) -> None:
        """Sync the table to the new frontier and release only the pages
        the next verify window can no longer reach (``pos .. pos +
        min(spec_k, remaining - 1)``): trim fires as a request's tail
        drains, not on every rollback."""
        table = self._tables[s]
        pos = int(self._pos[s])
        table.num_tokens = pos
        horizon = pos + min(
            self.spec_k, max(req.new_tokens - len(req.tokens) - 1, 0)
        )
        if table.trim(table.page_index(horizon) + 1):
            self._tables_changed()


# ------------------------------------------------------------------ reports
def latency_report(
    requests: Sequence[Request], batcher=None, registry=None
) -> dict:
    """p50/p95/p99 latency + TTFT + throughput over finished requests, plus
    the batcher's per-lane counts and host/device split when given, and
    the robustness block (shed, cancelled, failed, faults, the ladder) from
    ``registry`` (default: the batcher's) when any of it is non-empty."""
    done = [r for r in requests if r.t_done is not None]
    lanes: dict = {}
    if batcher is not None:
        st = batcher.stats
        lanes["lane_steps"] = st.lane_steps
        lanes["lane_calls"] = dict(st.lane_calls)
        # step-pipeline telemetry (DESIGN.md §13): how much host work ran
        # beside the device rather than serialised against it
        busy = st.host_plan_ms + st.device_wait_ms
        lanes["pipeline"] = {
            "async_steps": bool(batcher.async_steps),
            "host_plan_ms": round(st.host_plan_ms, 3),
            "device_wait_ms": round(st.device_wait_ms, 3),
            "overlap_ratio": round(st.host_plan_ms / busy, 4) if busy else 0.0,
            "inflight_depth": st.inflight_depth,
            "d2h_transfers": st.d2h_transfers,
        }
        if st.target_steps:
            lanes["tokens_per_target_step"] = round(
                st.tokens / st.target_steps, 3
            )
        if st.drafted_tokens:
            lanes["spec"] = {
                "k": batcher.spec_k,
                "drafted_tokens": st.drafted_tokens,
                "accepted_tokens": st.accepted_tokens,
                "acceptance_rate": round(
                    st.accepted_tokens / st.drafted_tokens, 4
                ),
                "k_bucket_crossings": st.k_bucket_crossings,
            }
            acc = np.array(batcher.accept_samples)
            if len(acc):
                lanes["spec"]["acceptance_p50"] = float(np.percentile(acc, 50))
                lanes["spec"]["acceptance_p95"] = float(np.percentile(acc, 95))
                lanes["spec"]["acceptance_p99"] = float(np.percentile(acc, 99))
    # Robustness block (DESIGN.md §15): shed/cancel/fault/degradation
    # accounting, derived from the registry the hardened loop feeds. A
    # clean run has every family empty, so the block is omitted.
    reg = registry
    if reg is None and batcher is not None:
        reg = batcher.telemetry.registry
    if reg is not None:
        robust: dict = {}
        for key, family, label in (
            ("shed", "admission_shed_total", "reason"),
            ("cancelled", "requests_cancelled_total", "reason"),
            ("failed", "requests_failed_total", "site"),
            ("faults_injected", "faults_injected_total", "site"),
            ("faults_detected", "faults_detected_total", "site"),
            ("faults_contained", "faults_contained_total", "site"),
            ("rung_dwell_s", "degrade_rung_dwell_s", "rung"),
            ("degrade_transitions", "degrade_transitions_total",
             "direction"),
        ):
            vals = reg.labeled_values(family, label)
            if vals:
                robust[key] = (
                    {k: round(v, 3) for k, v in vals.items()}
                    if key == "rung_dwell_s" else
                    {k: int(v) for k, v in vals.items()}
                )
        stragglers = reg.value("step_stragglers_total")
        if stragglers:
            robust["stragglers"] = int(stragglers)
        if batcher is not None and batcher.stats.deadline_missed:
            robust["deadline_missed"] = batcher.stats.deadline_missed
        if robust:
            lanes["robustness"] = robust
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
