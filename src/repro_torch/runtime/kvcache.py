"""Paged KV cache: page pool, block tables, and prefix sharing (DESIGN.md §9).

The dense serving cache gives every slot a private ``[max_len]`` KV buffer, so
memory — not compute — caps concurrency. This module replaces that with the
classic paged design: physical KV storage is a pool of fixed-size pages
(``[num_pages, page_size, KH, dh]`` on device), and each request owns a
*block table* — an ordered list of page ids — that maps its logical token
positions onto physical pages.

Everything in this module is **host-side cold-path bookkeeping**: the hot loop
only ever sees the packed ``[S, pages_bucket]`` int32 block-table array. The
capacity a request needs (its page count, rounded to a bucket) is a
*semi-static dispatch key* (DESIGN.md §2/§9): it changes rarely — once per
``pages_bucket * page_size`` generated tokens — relative to how often the
decode step executes, so the bucket picks the executable on the cold path and
the hot loop never re-checks capacity.

Components:

* ``PagePool``     — free list + per-page reference counts. Page 0 is the
                     reserved *null page*: inactive slots' writes land there,
                     it is never allocated, and no live block table points at
                     it.
* ``BlockTable``   — a request's page list + logical length. ``fork`` shares
                     every page (ref++) for cheap prefix cloning;
                     ``ensure_writable`` implements copy-on-write when a
                     shared page is about to be written.
* ``PrefixCache``  — a trie over *full pages* of prompt tokens mapping token
                     chunks to already-populated physical pages (vLLM-style
                     automatic prefix caching). Matching requests attach to
                     the shared pages instead of recomputing the prefix;
                     unreferenced cached pages are evicted LRU-first when the
                     pool runs dry.

Device-side page *contents* are moved by a ``copy_page`` callback supplied by
the engine (a single jitted gather/scatter, see ``models.copy_cache_pages``)
so this module stays importable without a device.

Pages may be stored quantised (DESIGN.md §12): ``kv_dtype`` labels the pool
and ``page_bytes`` prices a page (int8 pages cost ~1/4 of fp32, plus
per-token-row scale arrays that ride the device cache pytree — the same
``copy_page`` COWs them with the page bits). Host-side accounting is
dtype-blind: a page is a page; only its byte cost changes.
"""

from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Sequence

NULL_PAGE = 0

# Page storage dtypes (DESIGN.md §12). The dtype is a *dispatch coordinate*
# on the device side (one executable per kv_dtype); on this host side it is
# pure accounting: how many bytes a page costs, which is what matched-memory
# pool sizing (benchmarks/quantkv_bench.py) trades against page count.
KV_DTYPES = ("fp32", "int8")
_KV_ELEMENT_BYTES = {"fp32": 4, "int8": 1}
_SCALE_BYTES = 4  # f32 per-token-row scale, int8 pools only


def page_bytes(
    page_size: int, kv_heads: int, head_dim: int, kv_dtype: str = "fp32"
) -> int:
    """Device bytes one physical page costs (K + V, plus scales for int8).

    The matched-memory arithmetic of DESIGN.md §12: an int8 page stores the
    same ``page_size × KH × dh`` K/V elements in a quarter of the bytes,
    plus one f32 scale per token row per tensor — so a fixed byte budget
    buys ~4× the pages, which is what lets an int8 pool seat ~2× the
    concurrent requests under the seating gate.
    """
    if kv_dtype not in KV_DTYPES:
        raise KVCacheError(
            f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}"
        )
    elems = page_size * kv_heads * head_dim
    body = 2 * elems * _KV_ELEMENT_BYTES[kv_dtype]  # K + V
    scales = 2 * page_size * _SCALE_BYTES if kv_dtype == "int8" else 0
    return body + scales


class KVCacheError(RuntimeError):
    """Raised for page-accounting misuse (double free, foreign page, ...)."""


# ------------------------------------------------------------------ page pool
@dataclass
class PoolStats:
    allocs: int = 0
    frees: int = 0
    cow_copies: int = 0
    prefix_hits: int = 0  # pages attached from the prefix cache
    prefix_inserts: int = 0
    prefix_evictions: int = 0
    peak_in_use: int = 0
    alloc_failures: int = 0
    # Cross-pool migration accounting (DESIGN.md §17): pages handed to /
    # adopted from a sibling pool, with refcounts travelling intact.
    exports: int = 0
    imports: int = 0


class PagePool:
    """Fixed-size page allocator with reference counts.

    ``num_pages`` counts *allocatable* pages; with the default single shard
    the device cache holds ``num_pages + 1`` physical pages because page 0
    is the reserved null page (never allocated, target of inactive-slot
    writes).

    ``shards`` partitions the pool for data-parallel serving (DESIGN.md
    §16): shard ``s`` owns the contiguous physical block
    ``[s*(per_shard+1), (s+1)*(per_shard+1))`` with its *own* null page at
    the block's first id, so the device page axis splits evenly over the
    mesh's ``data`` axis and a slot's gathers/scatters never leave its
    shard. Page ids are physical-layout global; ``shard_of``/``is_null``
    decode them. ``shards=1`` reproduces the classic layout bit for bit
    (null page 0, ids 1..num_pages).

    ``kv_dtype`` records the pool's page storage dtype (DESIGN.md §12) —
    host-side metadata only (the device cache owns the actual arrays): it
    labels reports and feeds the matched-memory arithmetic via
    ``page_bytes``.
    """

    def __init__(
        self,
        num_pages: int,
        page_size: int,
        kv_dtype: str = "fp32",
        telemetry=None,
        shards: int = 1,
    ):
        if num_pages < 1:
            raise KVCacheError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise KVCacheError(f"page_size must be >= 1, got {page_size}")
        if kv_dtype not in KV_DTYPES:
            raise KVCacheError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}"
            )
        if shards < 1:
            raise KVCacheError(f"shards must be >= 1, got {shards}")
        if num_pages % shards:
            raise KVCacheError(
                f"num_pages ({num_pages}) must divide evenly over "
                f"{shards} shards"
            )
        self.num_pages = num_pages
        self.page_size = page_size
        self.kv_dtype = kv_dtype
        self.shards = shards
        self.per_shard = num_pages // shards
        self._block = self.per_shard + 1  # physical pages per shard block
        # per-shard free lists over physical-layout global ids; each
        # shard's first physical page is its null page, never allocated
        self._free: list[deque[int]] = [
            deque(range(s * self._block + 1, (s + 1) * self._block))
            for s in range(shards)
        ]
        self._ref = [0] * (shards * self._block)
        self.stats = PoolStats()
        # Flight-recorder hookup (core.telemetry, DESIGN.md §14): page
        # lifecycle events + occupancy counter samples on the "page-pool"
        # track. ``_trace`` is None unless recording, so the alloc/free hot
        # path pays one compare when telemetry is off.
        self.telemetry = telemetry
        self._trace = telemetry.trace_or_none() if telemetry else None
        self._faults = None  # core.faults.FaultPlan ("pool_alloc" site)

    # ------------------------------------------------------- shard geometry
    @property
    def num_physical(self) -> int:
        """Physical pages the device cache must hold (incl. null pages)."""
        return self.shards * self._block

    def shard_of(self, pid: int) -> int:
        self._check_pid(pid)
        return pid // self._block

    def is_null(self, pid: int) -> bool:
        return pid % self._block == 0

    def null_page(self, shard: int = 0) -> int:
        self._check_shard(shard)
        return shard * self._block

    def _check_shard(self, shard: int) -> None:
        if not 0 <= shard < self.shards:
            raise KVCacheError(
                f"shard {shard} outside pool [0, {self.shards})"
            )

    def attach_faults(self, plan) -> None:
        """Arm a ``core.faults.FaultPlan`` at the ``pool_alloc`` site: an
        injected fault makes one allocation report the pool dry. No caller
        can tell injected exhaustion from real exhaustion, by construction
        — containment is the pre-existing evict -> preempt -> defer
        admission machinery, exercised verbatim."""
        self._faults = plan

    def _occupancy_sample(self, rec) -> None:
        rec.counter(
            "pool_occupancy", "page-pool",
            pages_in_use=self.pages_in_use, pages_free=self.pages_free,
        )
        # Per-shard occupancy rides the always-on metrics registry with a
        # shard label (DESIGN.md §16) so a topology rebind's imbalance is
        # visible; single-shard pools keep the historical label-free gauge.
        if self.telemetry is not None and self.shards > 1:
            reg = self.telemetry.registry
            for s in range(self.shards):
                reg.set(
                    "pool_occupancy",
                    self.per_shard - len(self._free[s]),
                    shard=str(s),
                )

    # ------------------------------------------------------------ accounting
    @property
    def pages_free(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - self.pages_free

    def pages_free_in(self, shard: int) -> int:
        self._check_shard(shard)
        return len(self._free[shard])

    @property
    def total_tokens(self) -> int:
        """Token capacity of the allocatable pool."""
        return self.num_pages * self.page_size

    def refcount(self, pid: int) -> int:
        self._check_pid(pid)
        return self._ref[pid]

    def check(self) -> None:
        """Invariant: every page is exactly free or ref'd, never both/neither."""
        free: set[int] = set()
        for s, fl in enumerate(self._free):
            for pid in fl:
                if self.shard_of(pid) != s:
                    raise KVCacheError(
                        f"page {pid} on shard {s}'s free list belongs to "
                        f"shard {self.shard_of(pid)}"
                    )
                free.add(pid)
        if len(free) != self.pages_free:
            raise KVCacheError("free list contains duplicates")
        for pid in range(self.num_physical):
            if self.is_null(pid):
                if self._ref[pid] != 0:
                    raise KVCacheError(
                        f"null page {pid} acquired a refcount"
                    )
                continue
            if pid in free and self._ref[pid] != 0:
                raise KVCacheError(f"page {pid} free but ref={self._ref[pid]}")
            if pid not in free and self._ref[pid] == 0:
                raise KVCacheError(f"page {pid} leaked (ref=0, not free)")

    def _check_pid(self, pid: int) -> None:
        if not 0 <= pid < self.num_physical:
            raise KVCacheError(
                f"page id {pid} outside pool [0, {self.num_physical})"
            )

    # ------------------------------------------------------------- alloc/free
    def alloc(self, shard: int = 0) -> Optional[int]:
        """Pop a free page (from ``shard``) with ref=1, or None when dry."""
        self._check_shard(shard)
        rec = self._trace
        if self._faults is not None:
            f = self._faults.fire("pool_alloc")
            if f is not None:
                # injected transient exhaustion: indistinguishable from a
                # genuinely dry pool, so callers' recovery paths apply
                self.stats.alloc_failures += 1
                self._faults.note_detected("pool_alloc")
                if rec is not None:
                    rec.emit("alloc_failure", "page-pool",
                             args={"injected": True})
                return None
        if not self._free[shard]:
            self.stats.alloc_failures += 1
            if rec is not None:
                rec.emit("alloc_failure", "page-pool",
                         args={"shard": shard} if self.shards > 1 else None)
            return None
        pid = self._free[shard].popleft()
        self._ref[pid] = 1
        self.stats.allocs += 1
        self.stats.peak_in_use = max(self.stats.peak_in_use, self.pages_in_use)
        if rec is not None:
            rec.emit("page_alloc", "page-pool", args={"page": pid})
            self._occupancy_sample(rec)
        return pid

    def incref(self, pid: int) -> None:
        self._check_pid(pid)
        if self.is_null(pid):
            raise KVCacheError("cannot take a reference on the null page")
        if self._ref[pid] == 0:
            raise KVCacheError(f"incref on free page {pid}")
        self._ref[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        self._check_pid(pid)
        if self.is_null(pid):
            raise KVCacheError("cannot release the null page")
        if self._ref[pid] == 0:
            raise KVCacheError(f"double free of page {pid}")
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free[self.shard_of(pid)].append(pid)
            self.stats.frees += 1
            rec = self._trace
            if rec is not None:
                rec.emit("page_free", "page-pool", args={"page": pid})
                self._occupancy_sample(rec)
            return True
        return False

    # --------------------------------------- cross-pool migration (§17)
    def export_page(self, pid: int) -> int:
        """Hand a live page to a sibling pool: the id returns to this
        pool's free list and the page's refcount *travels with the caller*
        (to be re-established via ``import_page`` on the destination).
        The device-side contents move separately — a batched gather /
        ``device_put`` / scatter over the cache trees (DESIGN.md §17).
        Returns the travelling refcount."""
        self._check_pid(pid)
        if self.is_null(pid):
            raise KVCacheError("cannot export the null page")
        refs = self._ref[pid]
        if refs == 0:
            raise KVCacheError(f"export of free page {pid}")
        self._ref[pid] = 0
        self._free[self.shard_of(pid)].append(pid)
        self.stats.exports += 1
        rec = self._trace
        if rec is not None:
            rec.emit("page_export", "page-pool",
                     args={"page": pid, "refs": refs})
            self._occupancy_sample(rec)
        return refs

    def import_page(self, shard: int, refcount: int = 1) -> Optional[int]:
        """Adopt a page migrated from a sibling pool: allocate an id on
        ``shard`` carrying the traveller's ``refcount`` (conservation: the
        references ``export_page`` removed over there reappear here, never
        duplicated, never dropped). None when the shard is dry — the
        caller reclaims or preempts, exactly like a plain ``alloc``."""
        if refcount < 1:
            raise KVCacheError(
                f"imported refcount must be >= 1, got {refcount}"
            )
        pid = self.alloc(shard)
        if pid is None:
            return None
        self._ref[pid] = refcount
        self.stats.imports += 1
        rec = self._trace
        if rec is not None:
            rec.emit("page_import", "page-pool",
                     args={"page": pid, "refs": refcount})
        return pid


# ---------------------------------------------------------------- block table
@dataclass
class BlockTable:
    """One request's page mapping: ``pages[i]`` holds logical tokens
    ``[i*page_size, (i+1)*page_size)``; ``num_tokens`` is the logical length
    (== the request's next write position).

    ``shard`` is the table's pool-shard coordinate (DESIGN.md §16): every
    page it allocates or adopts comes from that shard's block, which is the
    host-side invariant that keeps device gathers shard-local under a
    data-parallel mesh. The default shard 0 is the whole pool when
    ``pool.shards == 1``.
    """

    pool: PagePool
    pages: list[int] = field(default_factory=list)
    num_tokens: int = 0
    shard: int = 0

    @property
    def capacity(self) -> int:
        return len(self.pages) * self.pool.page_size

    @property
    def num_pages(self) -> int:
        return len(self.pages)

    def page_index(self, pos: int) -> int:
        return pos // self.pool.page_size

    def adopt(self, pages: Sequence[int]) -> None:
        """Take ownership of already-incref'd pages (prefix attach); the
        pages must live in this table's shard."""
        for pid in pages:
            if self.pool.shard_of(pid) != self.shard:
                raise KVCacheError(
                    f"page {pid} (shard {self.pool.shard_of(pid)}) adopted "
                    f"into a shard-{self.shard} table"
                )
        self.pages.extend(pages)

    def append_page(self) -> bool:
        """Grow capacity by one freshly-allocated page. False on OOM."""
        pid = self.pool.alloc(self.shard)
        if pid is None:
            return False
        self.pages.append(pid)
        return True

    def ensure_capacity(self, pos: int) -> bool:
        """Make sure the page holding ``pos`` exists. False on OOM."""
        while self.page_index(pos) >= len(self.pages):
            if not self.append_page():
                return False
        return True

    def ensure_writable(
        self, pos: int, copy_page: Callable[[int, int], None] | None = None
    ) -> bool:
        """Copy-on-write: the page holding ``pos`` must be exclusively owned
        before the hot loop scatters new K/V into it. Returns False on OOM.

        ``copy_page(src, dst)`` moves device-side page contents; None skips
        the data move (host-only tests).
        """
        if not self.ensure_capacity(pos):
            return False
        idx = self.page_index(pos)
        pid = self.pages[idx]
        if self.pool.refcount(pid) == 1:
            return True
        new = self.pool.alloc(self.shard)
        if new is None:
            return False
        if copy_page is not None:
            copy_page(pid, new)
        self.pool.decref(pid)
        self.pages[idx] = new
        self.pool.stats.cow_copies += 1
        rec = self.pool._trace
        if rec is not None:
            rec.emit("cow_copy", "page-pool",
                     args={"src": pid, "dst": new})
        return True

    def trim(self, keep_pages: int) -> int:
        """Release every page beyond the first ``keep_pages`` — the paged
        half of speculative-decode rollback (DESIGN.md §11): KV written past
        the accepted prefix is *released or overwritten, never branched on*.
        Pages still inside ``keep_pages`` keep their rejected-tail garbage;
        the next committed write at those positions overwrites it. Returns
        the number of references dropped."""
        if keep_pages < 0:
            raise KVCacheError(f"keep_pages must be >= 0, got {keep_pages}")
        freed = 0
        while len(self.pages) > keep_pages:
            self.pool.decref(self.pages.pop())
            freed += 1
        return freed

    def fork(self) -> "BlockTable":
        """Clone sharing every physical page (ref++); writes then COW."""
        for pid in self.pages:
            self.pool.incref(pid)
        return BlockTable(
            pool=self.pool, pages=list(self.pages),
            num_tokens=self.num_tokens, shard=self.shard,
        )

    def release(self) -> None:
        """Drop this table's references; the table must not be used after."""
        for pid in self.pages:
            self.pool.decref(pid)
        self.pages = []
        self.num_tokens = 0


# --------------------------------------------------------------- prefix trie
class _TrieNode:
    __slots__ = ("chunk", "page", "children", "parent", "last_used")

    def __init__(
        self,
        chunk: tuple[int, ...] | None,
        page: int,
        parent: "_TrieNode | None",
    ):
        self.chunk = chunk
        self.page = page
        self.children: dict[tuple[int, ...], _TrieNode] = {}
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    """Trie over full-page prompt chunks -> populated physical pages.

    Each node pins its page with one pool reference (cached-but-idle pages
    stay resident until evicted). ``match`` walks the trie and *additionally*
    increfs each matched page on behalf of the attaching request, so a cached
    page referenced by R live requests has refcount R+1.

    Only *full* pages are cached: a partially-filled page is still being
    written by its owner and can never be safely shared (this is what makes
    writes COW-free on the prompt path — shared pages are read-only by
    construction).

    With a sharded pool (DESIGN.md §16) the cache keeps one trie per shard:
    a request seated on shard ``s`` can only adopt pages that physically
    live on shard ``s``, so ``match``/``insert`` take the shard coordinate
    and sharing never crosses the data axis (the honest cost of keeping
    gathers shard-local — the same prompt may be cached once per shard).
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._roots = [
            _TrieNode(None, pool.null_page(s), None)
            for s in range(pool.shards)
        ]
        self._clock = 0
        self._nodes = 0

    def __len__(self) -> int:
        return self._nodes

    @property
    def cached_pages(self) -> int:
        return self._nodes

    @property
    def _root(self) -> _TrieNode:  # single-shard convenience (tests, repr)
        return self._roots[0]

    def _chunks(self, tokens: Sequence[int]) -> list[tuple[int, ...]]:
        ps = self.pool.page_size
        n_full = len(tokens) // ps
        return [
            tuple(tokens[i * ps : (i + 1) * ps]) for i in range(n_full)
        ]

    # ----------------------------------------------------------------- match
    def match(
        self, tokens: Sequence[int], shard: int = 0
    ) -> tuple[list[int], int]:
        """Longest full-page prefix of ``tokens`` cached *on ``shard``*.

        Returns ``(page_ids, matched_tokens)``; every returned page has been
        incref'd for the caller (release via ``BlockTable.release`` once the
        pages are adopted into a table, or ``pool.decref`` directly).
        """
        self._clock += 1
        node = self._roots[shard]
        pages: list[int] = []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_used = self._clock
            self.pool.incref(child.page)
            pages.append(child.page)
            node = child
        self.pool.stats.prefix_hits += len(pages)
        return pages, len(pages) * self.pool.page_size

    # ---------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Register populated full pages for ``tokens``; returns #inserted.

        ``pages[i]`` must hold the KV of chunk i. Chunks already present are
        skipped (first writer wins — the existing page stays canonical).
        """
        self._clock += 1
        chunks = self._chunks(tokens)
        if len(pages) < len(chunks):
            raise KVCacheError(
                f"insert: {len(chunks)} full chunks but {len(pages)} pages"
            )
        shard = self.pool.shard_of(pages[0]) if pages else 0
        node = self._roots[shard]
        inserted = 0
        for chunk, pid in zip(chunks, pages):
            if self.pool.shard_of(pid) != shard:
                raise KVCacheError(
                    f"insert: page {pid} not on shard {shard}; a cached "
                    f"prefix cannot straddle pool shards"
                )
            child = node.children.get(chunk)
            if child is None:
                if self.pool.is_null(pid):
                    raise KVCacheError("cannot cache the null page")
                self.pool.incref(pid)  # the trie's own pin
                child = _TrieNode(chunk, pid, node)
                node.children[chunk] = child
                self._nodes += 1
                inserted += 1
                self.pool.stats.prefix_inserts += 1
            child.last_used = self._clock
            node = child
        return inserted

    # ----------------------------------------------------------------- evict
    def evict(self, want_pages: int = 1, shard: int | None = None) -> int:
        """Drop up to ``want_pages`` *idle* cached pages (LRU leaves first).

        A node is evictable when it has no children and its page's only
        remaining reference is the trie's pin (no live request shares it).
        ``shard`` restricts eviction to one shard's trie (a dry shard can
        only be refilled from its own cached pages); None sweeps all.
        Returns the number of pages actually freed back to the pool.

        One trie walk total: candidates are heaped up front, and evicting a
        leaf only re-examines its parent (which may have just become a
        leaf) — O(nodes + freed·log nodes), not O(nodes²).
        """
        if want_pages <= 0:
            return 0

        def evictable(n: _TrieNode) -> bool:
            return not n.children and self.pool.refcount(n.page) == 1

        heap = [
            (n.last_used, id(n), n)
            for n in self._iter_nodes(shard)
            if evictable(n)
        ]
        heapq.heapify(heap)
        freed = 0
        while freed < want_pages and heap:
            _, _, victim = heapq.heappop(heap)
            if not evictable(victim):  # stale entry (child added since)
                continue
            parent = victim.parent
            assert parent is not None and victim.chunk is not None
            del parent.children[victim.chunk]
            self._nodes -= 1
            self.pool.decref(victim.page)
            self.pool.stats.prefix_evictions += 1
            rec = self.pool._trace
            if rec is not None:
                rec.emit("prefix_evict", "page-pool",
                         args={"page": victim.page})
            freed += 1
            if parent not in self._roots and evictable(parent):
                heapq.heappush(heap, (parent.last_used, id(parent), parent))
        return freed

    def _iter_nodes(self, shard: int | None = None):
        roots = self._roots if shard is None else [self._roots[shard]]
        stack = [c for r in roots for c in r.children.values()]
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def reroot(self, mapping: dict[int, int]) -> int:
        """Rewrite cached page ids after a cross-pool migration.

        ``mapping`` is the ``{old_pid: new_pid}`` dict ``migrate_pages``
        returns. Nodes whose page migrated now point at the destination
        pool's id; untouched nodes keep theirs. The serving path keeps
        the trie rooted in the decode pool so this is usually a no-op
        there, but a trie over a migrated pool (tests, future drafts)
        needs its ids re-rooted or every later match hands out stale
        pages. Returns the number of nodes rewritten.
        """
        if not mapping:
            return 0
        hits = 0
        for n in self._iter_nodes(None):
            new = mapping.get(n.page)
            if new is not None:
                n.page = new
                hits += 1
        return hits

    def clear(self) -> int:
        """Release every cached page (pool drain helper)."""
        total = 0
        while True:
            freed = self.evict(self._nodes or 1)
            total += freed
            if freed == 0:
                return total


# --------------------------------------------------- cross-pool migration
def migrate_pages(
    src: PagePool,
    dst: PagePool,
    pids: Sequence[int],
    shard: int = 0,
) -> dict[int, int]:
    """Move live pages from ``src`` to ``dst`` (host bookkeeping only).

    Each page is exported from ``src`` (id freed, refcount captured) and
    imported into ``dst`` on ``shard`` under a fresh id carrying the same
    refcount — conservation holds: ``sum(refs)`` across both pools is
    unchanged. Device-side contents move separately (gather /
    ``device_put`` / scatter over the cache trees, DESIGN.md §17).
    Capacity is checked up front so a dry destination fails atomically
    (no partial export) — callers reclaim/preempt and retry.

    Returns ``{old_pid_in_src: new_pid_in_dst}``.
    """
    if not pids:
        return {}
    if dst.page_size != src.page_size:
        raise KVCacheError(
            "cannot migrate between pools with different page sizes: "
            f"{src.page_size} vs {dst.page_size}"
        )
    if dst.pages_free_in(shard) < len(pids):
        raise KVCacheError(
            f"destination shard {shard} has {dst.pages_free_in(shard)} free "
            f"pages, need {len(pids)}"
        )
    mapping: dict[int, int] = {}
    for pid in pids:
        refs = src.export_page(pid)
        new = dst.import_page(shard, refcount=refs)
        if new is None:  # unreachable after the capacity check above
            raise KVCacheError("destination pool ran dry mid-migration")
        mapping[pid] = new
    return mapping


# ------------------------------------------------------------- share metrics
def sharing_report(tables: Iterable[BlockTable], pool: PagePool) -> dict:
    """Logical vs physical page accounting across live block tables.

    ``share_ratio`` = logical pages referenced / distinct physical pages —
    1.0 means no sharing; 2.0 means every physical page backs two requests
    on average. ``logical_tokens`` > ``pool.total_tokens`` is the overcommit
    the dense design cannot express.
    """
    logical_pages = 0
    logical_tokens = 0
    physical: set[int] = set()
    for t in tables:
        logical_pages += len(t.pages)
        logical_tokens += t.num_tokens
        physical.update(t.pages)
    phys = len(physical)
    return {
        "logical_pages": logical_pages,
        "physical_pages": phys,
        "logical_tokens": logical_tokens,
        "pool_tokens": pool.total_tokens,
        "pages_in_use": pool.pages_in_use,
        "share_ratio": (logical_pages / phys) if phys else 1.0,
        "overcommit_ratio": (
            logical_tokens / pool.total_tokens if pool.total_tokens else 0.0
        ),
    }
