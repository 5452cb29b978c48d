"""The serving paths of the dense family over a mesh of logical devices
(DESIGN.md §16; ROADMAP A12 parts 2-3): tensor parallelism over ``model``
and data parallelism over ``data``, with the collectives where GSPMD puts
them in the JAX package.

**Weights** (``shard_params``) follow ``MeshPlan.param_specs`` (TP only):
each model shard ``m`` holds its piece of every split leaf and the whole of
every replicated one. The layout of the forward is read from those specs,
never assumed (``TPLayout``):

* ``wq``/``wk``/``wv`` column-parallel over heads, ``wo`` row-parallel, and
  an ``all_reduce`` over ``model`` after ``wo`` (Megatron's split);
* ``w_gate``/``w_up`` column-parallel over ``d_ff``, ``w_down``
  row-parallel, an ``all_reduce`` after it;
* a MoE tail (``models.moe.moe_shard``) with the router whole on every
  shard and the experts split where the rules put them: E over ``model``
  (EP: each shard runs the assignments of its own experts) or else F (TP
  on F: every assignment over the shard's slice). Each shard returns its
  float32 part of ``y``, and one ``all_reduce`` over ``model`` sums them,
  as after the dense ``w_down``; the sum is cast to the model dtype once;
* the embedding vocab-parallel: a masked lookup of the shard's rows, then
  an ``all_reduce``; the head (tied or not) gives vocab-parallel logits,
  then an ``all_gather``. Where the vocab does not divide, the rules split
  ``d_model`` instead: the lookup's columns are gathered, and the head's
  products over its columns are summed with an ``all_reduce``. An
  embeddings arch (a stub frontend's ``[B, S, D]``, no table) passes its
  inputs through, replicated over ``model`` and cast to the model dtype,
  and its head's spec alone sets the split (internvl2's 151655-entry vocab
  splits its width, musicgen's 2048 its vocab).

Where a spec leaves a weight whole (``num_kv_heads % mp != 0``: ``wk``/
``wv`` replicated while ``wq`` is split), each shard computes it whole, as
GSPMD would: every shard writes the whole K/V into its replica of the pool,
the query heads are gathered over ``model``, and each shard attends with
every head and keeps its own heads' output for its rows of ``wo``. Where
``wq`` itself is whole (``num_heads % mp != 0``), attention runs whole on
every shard and needs no reduction, except in full-sequence attention
(the training loss and ``prefill``, ``models.spmd``) under
``perf.seq_shard_fallback`` where ``model`` divides the sequence
(``sharding.attn_q_split``): there shard ``m`` projects the queries and
keys of its ``S / mp`` rows at their global positions, the keys are
gathered over ``model`` and V projected whole (the split GSPMD gives the
JAX package's step), each shard attends its queries over the whole K/V
and projects them through ``wo`` (whole there), and one tiled
``all_gather`` over ``model`` along the sequence joins the rows (each
gather's backward a ``reduce_scatter``). Norms and residuals run on every
shard as replicas. The speculative draft (``models.draft_view``) is the
same slices of the target's shards (``draft_shards``): views, no second
copy.

**The pool** (``ShardedCache``, ``init_mesh_paged_cache``) follows
``MeshPlan.paged_cache_specs``: data row ``d`` holds the physical page block
``[d·R, (d+1)·R)`` (R = physical pages / dp; with ``kvcache.PagePool``'s
shards, one or more shard blocks, each with its own null page), its kv heads
split over ``model`` where they divide. Block tables keep global page ids;
the step turns them into each row's local ids (an id outside the row, the
null padding, reads and writes the row's first null page). An int8 pool's
scales ``[m, P, ps]`` are replicated over ``model``, and one scale covers a
token row's every kv head: where the heads are split, each shard's absmax is
reduced with ``collectives.pmax`` over the row's shards before it rounds,
so every shard writes the whole row's scale and the bits a one-device pool
holds.

**The dense caches** (``init_mesh_dense_cache``: the dense engine's and
every draft's) follow ``MeshPlan.dense_cache_specs``: slots over ``data``
(``slots % dp == 0``, else ``ValueError``), the kv heads over ``model``
where they divide, **else the sequence**: shard ``m`` then holds positions
``[m·L/mp, (m+1)·L/mp)`` of every head. Attention needs the whole row, so
there each shard gathers the row's pieces over ``model`` (one copy of the
row's cache a layer), writes the new rows into the gathered cache and
attends over its page view with the unchanged kernels, then copies its own
positions back: a new row lands only in the piece that owns its position.
The scales ``[m, S, L]`` stay whole on every shard.

**Slots**: slot ``s`` runs on data row ``s·dp // S`` — the row that holds
its pool shard (``s·shards // S``, ``runtime.scheduler``) or its dense
cache rows — so rows are the equal contiguous groups ``row_spec`` gives
when ``S % dp == 0``. Each row's devices run every layer on its slots;
kernels B1-B4 launch on each shard's heads over its pool block or dense
rows. The rows' logits are gathered over ``data`` onto the mesh's first
device, where the step samples once.

**Page migration** (the ``mg`` lane of a disaggregated split whose slices
are meshes, DESIGN.md §17): ``gather_mesh_pages`` reads a request's pages
out of the pool into one block in the global layout (every kv head in
order, the replicated scales once) and ``scatter_mesh_pages`` writes such a
block into another pool of any layout, each page into the row that holds
it and each head into its model shard; the two ends never assume each
other's layout.

Attention stacks with MLP or MoE tails are served (``check_family``), on
token or embeddings inputs (the continuous engines refuse an embeddings
arch with ``ValueError`` before any mesh, as the JAX package's do); SSM
and hybrid stacks raise ``NotImplementedError`` (ROADMAP A12 part 3) in
the engine before anything here runs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import torch
import torch.utils.checkpoint as checkpoint_utils

from repro_torch import capture_analysis
from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd

from . import attention as attn
from . import mlp as mlp_mod
from . import moe as moe_mod
from .blocks import _scale, _is_local
from .layers import embed_apply, head_apply, norm_apply, softcap


def check_family(cfg: ArchConfig) -> None:
    """The tensor-parallel path serves attention stacks with MLP or MoE
    tails (token or embeddings inputs)."""
    for slot in range(cfg.period):
        if not cfg.mixer_at(slot).startswith("attn"):
            raise NotImplementedError(
                f"{cfg.name}: slot {slot} ({cfg.mixer_at(slot)}, "
                f"{cfg.mlp_at(slot)}) on a plan of more than one device "
                f"waits for {shd.PART3}: the tensor-parallel path serves "
                f"attention stacks with MLP or MoE tails")


def vocab_split(cfg: ArchConfig, specs: dict) -> tuple[bool, bool]:
    """(the vocab over ``model``, else ``d_model`` over ``model``) from the
    table's spec ``[V, D]``, or an embeddings arch's head's ``[D, V]`` (it
    has no table; an untied head of a token arch splits where its table
    does)."""
    if cfg.input_kind == "tokens":
        vocab, width = specs["embed.embedding"]
    else:
        width, vocab = specs["head.lm_head"]
    return "model" in shd.spec_axes(vocab), "model" in shd.spec_axes(width)


@dataclass(frozen=True)
class TPLayout:
    """What a mesh's resolved specs split, and where each slot runs."""

    dp: int
    mp: int
    heads: bool  # wq/wo split over model (num_heads % mp == 0)
    kv: bool  # wk/wv and the pool's heads split (num_kv_heads % mp == 0)
    mlp: bool  # w_gate/w_up/w_down split over d_ff
    moe: str | None  # the experts over model: "experts", "ffn" or whole
    vocab: bool  # the embedding and the head split over the vocab
    width: bool  # ... else over d_model (a vocab 'model' does not divide)
    rows: tuple  # (lo, hi) slot range of each data row
    row_block: int  # physical pages per data row

    def local_cfg(self, cfg: ArchConfig, *, kv_whole: bool = False
                  ) -> ArchConfig:
        """``cfg`` at one shard's head counts (no ``validate``: a shard's
        query heads need not divide its kv heads' group)."""
        h = cfg.num_heads // self.mp if self.heads else cfg.num_heads
        kh = (cfg.num_kv_heads // self.mp if self.kv and not kv_whole
              else cfg.num_kv_heads)
        return replace(cfg, num_heads=h, num_kv_heads=kh)


def layout_for(cfg: ArchConfig, specs: dict, plan: shd.MeshPlan,
               slots: int, physical_pages: int) -> TPLayout:
    """The layout ``specs`` (``plan.param_specs``) give, with ``slots``
    grouped by data row."""
    def split(key: str) -> bool:
        return key in specs and shd.splits(specs[key], "model")

    vocab, width = vocab_split(cfg, specs)
    slot0 = "blocks.0."
    rows = tuple(
        (next((s for s in range(slots) if s * plan.dp // slots == d), slots),
         next((s for s in range(slots) if s * plan.dp // slots > d), slots))
        for d in range(plan.dp))
    return TPLayout(
        dp=plan.dp, mp=plan.mp,
        heads=split(slot0 + "attn.wq"), kv=split(slot0 + "attn.wk"),
        mlp=split(slot0 + "mlp.w_gate"), moe=moe_mod.moe_split(specs),
        vocab=vocab, width=width,
        rows=rows, row_block=physical_pages // plan.dp,
    )


# ---------------------------------------------------------------- weights
def shard_params(params: dict, specs: dict, mesh: shd.LogicalMesh,
                 memo: dict) -> dict:
    """Each coordinate's weights: a split leaf's piece (a contiguous copy on
    the coordinate's device), a replicated leaf moved there (``.to`` of a
    tensor already on that device is the tensor itself; so is every leaf
    of a mesh whose model axis has one device). ``memo`` keys pieces by
    (device, leaf, model size, model index), so data rows on one card, and
    every mesh of one model size, share them."""
    out = {}
    a = mesh.axis("model")
    mp = mesh.shape["model"]
    for c in mesh.coords():
        dev = mesh.device(c)
        shard: dict = {}
        for key, t in params.items():
            spec = specs[key]
            if mp == 1 or not shd.splits(spec, "model"):
                shard[key] = t.to(dev)  # whole on every coordinate
                continue
            mk = (str(dev), key, mp, c[a])
            if mk not in memo:
                sl = shd.shard_slices(t.shape, spec, mesh, c)
                memo[mk] = t[sl].to(dev, copy=True).contiguous()
            shard[key] = memo[mk]
        out[c] = shard
    return out


# ------------------------------------------------------------------- pool
class ShardedCache(list):
    """A mesh's page pool or dense cache: every coordinate's per-period-slot
    leaf dicts in coordinate order (so what walks a cache — zeroing,
    parking, copying one cache into another of the same mesh — walks the
    pieces), with ``shards`` (coordinate -> its period-slot list), ``mesh``,
    ``specs`` (per period slot, leaf -> spec), the global ``shapes``,
    ``row_block`` (a pool's physical pages per data row) and ``seq_split``
    (a dense cache whose sequence axis is split over ``model``)."""

    def __init__(self, mesh, shards: dict, specs: list, shapes: list,
                 row_block: int, seq_split: bool = False):
        super().__init__(d for c in mesh.coords() for d in shards[c])
        self.mesh = mesh
        self.shards = shards
        self.specs = specs
        self.shapes = shapes
        self.row_block = row_block
        self.seq_split = seq_split


def _zeroed_pieces(mesh, global_cache: list, specs: list) -> dict:
    """Each coordinate's zeroed pieces of ``global_cache`` (meta tensors)
    on its device."""
    return {
        c: [{n: torch.zeros(shd.local_shape(t.shape, sp[n], mesh),
                            dtype=t.dtype, device=mesh.device(c))
             for n, t in d.items()}
            for d, sp in zip(global_cache, specs)]
        for c in mesh.coords()
    }


def _shapes(global_cache: list) -> list:
    return [{n: tuple(t.shape) for n, t in d.items()} for d in global_cache]


def init_mesh_paged_cache(plan: shd.MeshPlan, global_cache: list,
                          ) -> ShardedCache:
    """The pool of a multi-device ``plan`` for the global layout
    ``global_cache`` (``models.init_paged_cache`` on the ``meta`` device):
    each coordinate's zeroed piece on its device."""
    mesh = plan.mesh
    specs = plan.paged_cache_specs(global_cache)
    phys = global_cache[0]["k"].shape[1]
    return ShardedCache(mesh, _zeroed_pieces(mesh, global_cache, specs),
                        specs, _shapes(global_cache), phys // plan.dp)


def init_mesh_dense_cache(plan: shd.MeshPlan, global_cache: list,
                          ) -> ShardedCache:
    """The dense per-slot cache of a multi-device ``plan`` for the global
    layout ``global_cache`` (``models.init_cache`` on the ``meta`` device:
    the dense engine's, or a draft's of either dtype): each coordinate's
    zeroed piece on its device. Slots must divide over the data rows."""
    mesh = plan.mesh
    slots = global_cache[0]["k"].shape[1]
    if slots % plan.dp:
        raise ValueError(
            f"a dense cache of {slots} slots on mesh {plan.name!r}: the "
            f"slots must divide over its {plan.dp} data rows (each row "
            f"holds its slots' cache rows)")
    specs = plan.dense_cache_specs(global_cache)
    return ShardedCache(mesh, _zeroed_pieces(mesh, global_cache, specs),
                        specs, _shapes(global_cache), slots // plan.dp,
                        seq_split=specs[0]["k"][2] == "model")


def draft_shards(params: dict, draft_cfg: ArchConfig) -> dict:
    """The draft view's weights on a mesh: each coordinate's target shard
    with every ``blocks.*`` piece sliced to the draft's depth (views of the
    target's pieces, as ``models.draft_view`` of the whole weights)."""
    d = draft_cfg.num_layers // draft_cfg.period
    return {c: {k: (t[:d] if k.startswith("blocks.") else t)
                for k, t in shard.items()}
            for c, shard in params.items()}


def _global_leaf(cache: list, i: int, name: str,
                 device: torch.device) -> torch.Tensor:
    if isinstance(cache, ShardedCache):
        pieces = {c: cache.shards[c][i][name] for c in cache.mesh.coords()}
        return shd.unshard(pieces, cache.specs[i][name], cache.mesh, device)
    return cache[i][name].to(device)


def relayout_cache(dst: list, src: list) -> None:
    """Copy pool ``src`` into pool ``dst`` of any layout (one device or a
    mesh's pieces): global page ``p`` of every leaf lands at ``p`` of the
    other layout. In place: ``dst``'s tensors are written, never rebound
    (the graphs captured over them hold their addresses)."""
    if not isinstance(dst, ShardedCache) and not isinstance(src,
                                                            ShardedCache):
        for d, s in zip(dst, src):
            for name, t in d.items():
                t.copy_(s[name])
        return
    sharded = isinstance(dst, ShardedCache)
    for i in range(len(dst.specs) if sharded else len(dst)):
        for name in (dst.specs[i] if sharded else dst[i]):
            if sharded:
                first = dst.shards[dst.mesh.coords()[0]][i][name]
                g = _global_leaf(src, i, name, first.device)
                for c in dst.mesh.coords():
                    piece = dst.shards[c][i][name]
                    piece.copy_(g[shd.shard_slices(
                        dst.shapes[i][name], dst.specs[i][name], dst.mesh,
                        c)])
            else:
                t = dst[i][name]
                t.copy_(_global_leaf(src, i, name, t.device))


def _per_device(fn):
    """A mesh step: every op inside runs once per coordinate, so a capture
    report counts 1/devices of them to a device (``capture_analysis.
    spread``); the mesh is the one of the ``ShardedCache`` argument."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        cache = next(a for a in args if isinstance(a, ShardedCache))
        with capture_analysis.spread(cache.mesh.size):
            return fn(*args, **kwargs)

    return wrapper


def _page_rows(cache: ShardedCache, idx: torch.Tensor) -> tuple:
    """Each global page id's data row and its local id in that row's
    block."""
    row = torch.div(idx, cache.row_block, rounding_mode="floor")
    return row, idx - row * cache.row_block


def _model_dim(spec: tuple) -> int | None:
    """The dim a leaf splits over ``model`` (kv heads), None if whole."""
    return next((j for j, e in enumerate(spec) if "model" in
                 shd.spec_axes(e)), None)


@_per_device
def gather_mesh_pages(cache: ShardedCache, idx: torch.Tensor,
                      leaves: list) -> tuple:
    """The ``mg`` gather over a mesh's pool: ``idx[B]`` global page ids (on
    the mesh's first device) -> one block per leaf of ``leaves`` ((period
    slot, name) in block order) in the global layout, ``[m, B, ...]`` with
    every kv head in global order, on the mesh's first device: the unit
    both ends of a migration agree on, whatever their layouts. Each
    coordinate reads the pages of its own row's block (an id of another
    row reads the row's null page); the row's heads are joined over
    ``model`` (``all_gather``; a leaf whole on every model shard, as the
    int8 scales, is taken from the first) and each page is then taken from
    the row that holds it (``all_gather`` over ``data``)."""
    mesh = cache.mesh
    first = mesh.device(mesh.coords()[0])
    idx = idx.long()
    row, loc = _page_rows(cache, idx)
    dp = mesh.shape["data"]
    out = []
    for i, n in leaves:
        spec = cache.specs[i][n]
        dim = _model_dim(spec)
        mine = {}
        for c in mesh.coords():
            piece = cache.shards[c][i][n]
            at = torch.where(row == c[0], loc, torch.zeros_like(loc))
            mine[c] = piece[:, at.to(piece.device)]
        if dim is not None:
            mine = coll.all_gather(mine, mesh, "model", dim=dim, tiled=True)
        if dp == 1:
            out.append(mine[mesh.coords()[0]].to(first))
            continue
        stacked = coll.all_gather(mine, mesh, "data")[mesh.coords()[0]]
        stacked = stacked.to(first)
        block = stacked[0]
        shape = (1, -1) + (1,) * (block.dim() - 2)
        for d in range(1, dp):
            block = torch.where((row == d).view(shape), stacked[d], block)
        out.append(block)
    return tuple(out)


@_per_device
def scatter_mesh_pages(cache: ShardedCache, idx: torch.Tensor,
                       leaves: list, block: tuple) -> None:
    """The ``mg`` scatter over a mesh's pool, in place: each page ``j`` of
    ``block`` (global layout, as ``gather_mesh_pages`` gives it) lands at
    global id ``idx[j]``, in the row that holds it and in each model
    shard's heads (a leaf whole on every model shard, as the int8 scales,
    on every one). A row writes only its own ids, so what another row's
    block holds, its null page included, keeps its bits: an entry of
    another row is redirected onto the row's first own entry, with that
    entry's value, or where the row has none onto its null page with the
    page's own value (duplicate ids then always carry equal values)."""
    mesh = cache.mesh
    idx = idx.long()
    row, loc = _page_rows(cache, idx)
    order = torch.arange(idx.shape[0], device=idx.device)
    for (i, n), b in zip(leaves, block):
        spec = cache.specs[i][n]
        dim = _model_dim(spec)
        for d in range(mesh.shape["data"]):
            mine = row == d
            some = mine.any()
            j = torch.where(mine, order, mine.to(torch.int32).argmax())
            at = torch.where(some, loc[j], torch.zeros_like(loc))
            for c in (c for c in mesh.coords() if c[0] == d):
                piece = cache.shards[c][i][n]
                dev = piece.device
                vals = b.to(dev)
                if dim is not None:
                    w = piece.shape[dim]
                    vals = vals.narrow(dim, c[1] * w, w)
                vals = torch.where(some.to(dev), vals[:, j.to(dev)],
                                   piece[:, :1])
                piece[:, at.to(dev)] = vals


def copy_mesh_pages(cache: ShardedCache, src: int, dst: int) -> None:
    """``models.copy_cache_pages`` on a mesh's pool: both pages lie in one
    data row's block (a table only holds pages of its slot's shard); every
    coordinate of that row copies its piece."""
    rb = cache.row_block
    row = src // rb
    if dst // rb != row:
        raise ValueError(f"copy-on-write across data rows: page {src} (row "
                         f"{row}) -> {dst} (row {dst // rb})")
    a = cache.mesh.axis("data")
    for c in cache.mesh.coords():
        if c[a] != row:
            continue
        for slot_cache in cache.shards[c]:
            for t in slot_cache.values():
                t[:, dst - row * rb] = t[:, src - row * rb]


# ---------------------------------------------------------------- forward
def _local_tables(bt: torch.Tensor, row: int, block: int) -> torch.Tensor:
    """Global page ids -> the row's local ids; ids outside the row (null
    padding of another shard) -> the row's first null page."""
    loc = bt - row * block
    return torch.where((loc >= 0) & (loc < block), loc, torch.zeros_like(loc))


class _Row:
    """One data row's shards: its coordinates (``(d, m)`` for each model
    index ``m``, or the ``coords`` given: a row of a mesh with a ``pod``
    axis), devices, weights and cache pieces (none for a cacheless
    training forward), and the collectives over its model axis. ``seq_q``
    (full-sequence attention only) splits attention's query rows over
    ``model`` where ``wq`` is whole (``sharding.attn_q_split``'s "seq")."""

    def __init__(self, lay: TPLayout, mesh, params: dict,
                 cache: ShardedCache | None, d: int,
                 coords: list | None = None, seq_q: bool = False):
        self.lay, self.mesh, self.seq_q = lay, mesh, seq_q
        self.coords = coords or [(d, m) for m in range(lay.mp)]
        self.devs = [mesh.device(c) for c in self.coords]
        self.params = [params[c] for c in self.coords]
        self.caches = (None if cache is None
                       else [cache.shards[c] for c in self.coords])
        self.seq_split = cache is not None and cache.seq_split
        self._views: dict = {}

    def layer(self, m: int, i: int, slot: int) -> tuple[dict, dict]:
        """Shard ``m``'s layer ``i`` of period slot ``slot``: its weights
        (nested, as the blocks take them) and its cache views."""
        key = (m, i, slot)
        if key not in self._views:
            prefix = f"blocks.{slot}."
            p: dict = {}
            for name, t in self.params[m].items():
                if name.startswith(prefix):
                    module, leaf = name[len(prefix):].split(".", 1)
                    p.setdefault(module, {})[leaf] = t[i]
            views = {} if self.caches is None else {
                k: t[i] for k, t in self.caches[m][slot].items()}
            self._views[key] = (p, views)
        return self._views[key]

    def each(self, t: torch.Tensor) -> list:
        return [t.to(dv) for dv in self.devs]

    def reduce(self, xs: list) -> list:
        out = coll.all_reduce(dict(zip(self.coords, xs)), self.mesh, "model")
        return [out[c] for c in self.coords]

    def gather(self, xs: list, dim: int) -> list:
        out = coll.all_gather(dict(zip(self.coords, xs)), self.mesh, "model",
                              dim=dim, tiled=True)
        return [out[c] for c in self.coords]

    def pmax(self, xs: list) -> list:
        out = coll.pmax(dict(zip(self.coords, xs)), self.mesh, "model")
        return [out[c] for c in self.coords]


def _embed(cfg: ArchConfig, row: _Row, toks: list) -> list:
    lay = row.lay
    if cfg.input_kind != "tokens":  # embeddings, replicated over model
        return [embed_apply(cfg, p, t) for p, t in zip(row.params, toks)]
    if not lay.vocab:
        xs = [embed_apply(cfg, p, t) for p, t in zip(row.params, toks)]
        return row.gather(xs, dim=-1) if lay.width else xs
    xs = []
    for m, (p, t) in enumerate(zip(row.params, toks)):
        table = p["embed.embedding"]
        n = table.shape[0]
        ids = t - m * n
        ok = (ids >= 0) & (ids < n)
        x = embed_apply(cfg, {"embed.embedding": table},
                        torch.where(ok, ids, torch.zeros_like(ids)))
        xs.append(x * ok[..., None].to(x.dtype))
    return row.reduce(xs)


def _width_product(cfg: ArchConfig, row: _Row, xs: list) -> list:
    """Where the head splits ``d_model``: each shard's columns of the
    product, summed (every shard's copy, at the model dtype)."""
    parts = []
    for m, (p, x) in enumerate(zip(row.params, xs)):
        w = (p["embed.embedding"].T
             if cfg.tie_embeddings and cfg.input_kind == "tokens"
             else p["head.lm_head"])
        n = w.shape[0]
        parts.append(x[..., m * n:(m + 1) * n] @ w)
    return row.reduce(parts)


def _shard_logits(cfg: ArchConfig, row: _Row, xs: list) -> list:
    """Each shard's float32 logits: its vocab columns where the head splits
    the vocab, else the whole vocab."""
    if row.lay.width:
        return [softcap(t.float(), cfg.final_logit_softcap)
                for t in _width_product(cfg, row, xs)]
    return [head_apply(cfg, p, x) for p, x in zip(row.params, xs)]


def _head(cfg: ArchConfig, row: _Row, xs: list) -> torch.Tensor:
    """The row's whole logits, on its first shard."""
    if row.lay.width:
        return softcap(_width_product(cfg, row, xs)[0].float(),
                       cfg.final_logit_softcap)
    logits = _shard_logits(cfg, row, xs)
    if row.lay.vocab:
        logits = row.gather(logits, dim=-1)
    return logits[0]


def _attend(cfg: ArchConfig, row: _Row, slot: int, i: int, hs: list,
            positions: list, core) -> list:
    """One layer's attention on every shard of a row -> each shard's share
    of the output (reduced over ``model`` when ``wo`` is split). ``core(
    acfg, caches, qs, ks, vs, local, amax)`` writes and attends on every
    shard -> each shard's output; ``amax[m]`` is the (K, V) row absmax
    over all kv heads where shard ``m`` holds some of them of an int8 cache
    (``collectives.pmax``), else None. On a ``seq_q`` row the core is also
    given ``offsets``, each shard's first query position."""
    lay = row.lay
    local = _is_local(cfg, slot)
    if row.seq_q:
        return _attend_rows(cfg, row, slot, i, hs, positions, core, local)
    kv_whole = lay.heads and not lay.kv
    lcfg = lay.local_cfg(cfg, kv_whole=kv_whole)
    ps, cs, qs, ks, vs = [], [], [], [], []
    for m in range(lay.mp):
        p, c = row.layer(m, i, slot)
        q, k, v = attn._qkv(lcfg, p["attn"], hs[m], positions[m])
        for xs, x in ((ps, p), (cs, c), (qs, q), (ks, k), (vs, v)):
            xs.append(x)
    amax = [None] * lay.mp
    if lay.kv and lay.mp > 1 and cs[0] and cs[0]["k"].dtype == torch.int8:
        amax = list(zip(row.pmax([attn.kv_row_amax(k) for k in ks]),
                        row.pmax([attn.kv_row_amax(v) for v in vs])))
    if kv_whole:  # every head attends on every shard; each keeps its own
        h = lcfg.num_heads
        os = core(cfg, cs, row.gather(qs, dim=2), ks, vs, local, amax)
        os = [o[:, :, m * h:(m + 1) * h] for m, o in enumerate(os)]
    else:
        os = core(lcfg, cs, qs, ks, vs, local, amax)
    outs = [attn._out_proj(lcfg, p["attn"], o) for p, o in zip(ps, os)]
    return row.reduce(outs) if lay.heads else outs


def _attend_rows(cfg: ArchConfig, row: _Row, slot: int, i: int, hs: list,
                 positions: list, core, local: bool) -> list:
    """Context-parallel attention of a ``seq_q`` row: shard ``m`` projects
    the queries and keys of rows ``[m·n, (m+1)·n)`` (n = S / mp) at their
    global positions, the keys are joined over ``model`` (``all_gather``
    along the sequence) and V is projected whole, as GSPMD partitions the
    JAX package's step (its flops to the op); each shard attends its
    queries over the whole K/V and projects them through ``wo``, and the
    rows are joined along the sequence by one more ``all_gather``."""
    mp = row.lay.mp
    n = hs[0].shape[1] // mp
    ps, cs, qs, ks, vs = [], [], [], [], []
    for m in range(mp):
        p, c = row.layer(m, i, slot)
        mine = slice(m * n, (m + 1) * n)
        h, at = hs[m][:, mine], positions[m][:, mine]
        for xs, x in ((ps, p), (cs, c), (qs, attn._q(cfg, p["attn"], h, at)),
                      (ks, attn._k(cfg, p["attn"], h, at)),
                      (vs, attn._v(cfg, p["attn"], hs[m]))):
            xs.append(x)
    ks = row.gather(ks, dim=1)
    os = core(cfg, cs, qs, ks, vs, local, [None] * mp,
              offsets=[m * n for m in range(mp)])
    return row.gather([attn._out_proj(cfg, p["attn"], o)
                       for p, o in zip(ps, os)], dim=1)


def _moe(cfg: ArchConfig, row: _Row, slot: int, i: int, hs: list,
         moe_policy: str, with_aux: bool) -> tuple[list, list | None]:
    """One MoE tail on every shard of a row -> (each shard's ``y`` in the
    model dtype, with ``with_aux`` each shard's ``moe.aux_stats``, else
    None: serving computes no aux term)."""
    lay = row.lay
    ys, stats = [], []
    for m in range(lay.mp):
        p = row.layer(m, i, slot)[0]["moe"]
        moe_mod.check_mesh_opts(cfg, p, lay.moe, lay.mp)
        lo = m * p["w_gate"].shape[0] if lay.moe == "experts" else 0
        y, idx, probs = moe_mod.moe_shard(cfg, p, hs[m], policy=moe_policy,
                                          lo=lo, partial=lay.moe is not None)
        ys.append(y)
        if with_aux:
            stats.append(moe_mod.aux_stats(cfg, idx, probs))
    if lay.moe is not None:  # the float32 parts summed, then one cast
        ys = [y.to(h.dtype) for y, h in zip(row.reduce(ys), hs)]
    return ys, (stats if with_aux else None)


def _mlp(cfg: ArchConfig, row: _Row, slot: int, i: int, xs: list,
         moe_policy: str = "drop",
         with_aux: bool = False) -> tuple[list, list | None]:
    """The residual MLP or MoE tail on every shard -> (xs, with
    ``with_aux`` each shard's aux sums of a MoE slot, else None)."""
    kind = cfg.mlp_at(slot)
    if kind == "none":
        return xs, None
    hs = [norm_apply(cfg, _scale(row.layer(m, i, slot)[0], "norm2"), xs[m])
          for m in range(row.lay.mp)]
    stats = None
    if kind == "moe":
        outs, stats = _moe(cfg, row, slot, i, hs, moe_policy, with_aux)
    else:
        outs = [mlp_mod.mlp_apply(cfg, row.layer(m, i, slot)[0]["mlp"], h)
                for m, h in enumerate(hs)]
        if row.lay.mlp:
            outs = row.reduce(outs)
    return [x + o for x, o in zip(xs, outs)], stats


def _tower(cfg: ArchConfig, row: _Row, toks: list, positions: list,
           core, remat: bool = False, moe_policy: str = "drop",
           aux: list | None = None) -> list:
    """Embed, every layer (attention then the MLP or MoE tail, residuals
    on every shard), the final norm -> each shard's hidden state
    (replicas). ``remat`` recomputes each period of layers in the backward
    pass, as ``models.forward``'s. With ``aux`` (a list) each MoE layer
    appends every shard's ``moe.aux_stats`` (a list of ``[2, E]``)."""
    mp = row.lay.mp

    def period(i: int, *xs: torch.Tensor) -> tuple:
        xs, got = list(xs), []
        for slot in range(cfg.period):
            hs = [norm_apply(cfg, _scale(row.layer(m, i, slot)[0], "norm1"),
                             xs[m]) for m in range(mp)]
            a = _attend(cfg, row, slot, i, hs, positions, core)
            xs = [x + o for x, o in zip(xs, a)]
            xs, stats = _mlp(cfg, row, slot, i, xs, moe_policy,
                             with_aux=aux is not None)
            if stats is not None:
                got += stats
        return (*xs, *got)  # outputs, so that a remat region returns them

    xs = _embed(cfg, row, toks)
    for i in range(cfg.num_layers // cfg.period):
        if remat:
            from .model import _remat_context

            out = checkpoint_utils.checkpoint(
                period, i, *xs, use_reentrant=False,
                context_fn=_remat_context)
        else:
            out = period(i, *xs)
        xs, got = list(out[:mp]), out[mp:]
        if aux is not None:
            aux.extend(list(got[j:j + mp]) for j in range(0, len(got), mp))
    return [norm_apply(cfg, p.get("final_norm.scale"), x)
            for p, x in zip(row.params, xs)]


def _rows(lay: TPLayout, mesh, params: dict, cache: ShardedCache):
    for d, (lo, hi) in enumerate(lay.rows):
        if hi > lo:
            yield d, lo, hi, _Row(lay, mesh, params, cache, d)


@_per_device
def mesh_paged_decode_step(
    cfg: ArchConfig, lay: TPLayout, params: dict, cache: ShardedCache,
    inputs: torch.Tensor, pos: torch.Tensor, block_tables: torch.Tensor,
    *, attn_impl: str = "kernel", moe_policy: str = "drop",
) -> torch.Tensor:
    """``models.paged_decode_step`` over the mesh: inputs i32[S,1], pos
    i32[S], block_tables i32[S,PB] (global ids) on the mesh's first device
    -> logits [S,V] float32 there; every shard's pool piece updated in
    place."""
    mesh = cache.mesh
    out = {}
    for d, lo, hi, row in _rows(lay, mesh, params, cache):
        p = row.each(pos[lo:hi])
        bt = row.each(_local_tables(block_tables[lo:hi], d, lay.row_block))

        def core(acfg, cs, qs, ks, vs, local, amax, p=p, bt=bt):
            return [attn.paged_decode_core(
                acfg, c, q, k, v, p[m], bt[m], local=local,
                attn_impl=attn_impl, amax=amax[m])
                for m, (c, q, k, v) in enumerate(zip(cs, qs, ks, vs))]

        xs = _tower(cfg, row, row.each(inputs[lo:hi]),
                    [x[:, None] for x in p], core, moe_policy=moe_policy)
        out[d, 0] = _head(cfg, row, [x[:, -1] for x in xs])
    return _gather_rows(mesh, out)


@_per_device
def _paged_chunk(cfg, lay, params, cache, inputs, start, block_tables,
                 length, attn_impl: str, every_row: bool,
                 moe_policy: str) -> torch.Tensor:
    """The paged chunk tower over the mesh -> the logits of each row's last
    real chunk row [S,V], or with ``every_row`` of every row [S,C,V]."""
    from .model import _last_real_row

    mesh = cache.mesh
    out = {}
    c_len = inputs.shape[1]
    for d, lo, hi, row in _rows(lay, mesh, params, cache):
        st = row.each(start[lo:hi])
        ln = row.each(length[lo:hi])
        bt = row.each(_local_tables(block_tables[lo:hi], d, lay.row_block))

        def core(acfg, cs, qs, ks, vs, local, amax, st=st, bt=bt, ln=ln):
            return [attn.paged_prefill_core(
                acfg, c, q, k, v, st[m], bt[m], ln[m], local=local,
                attn_impl=attn_impl, amax=amax[m])
                for m, (c, q, k, v) in enumerate(zip(cs, qs, ks, vs))]

        xs = _tower(cfg, row, row.each(inputs[lo:hi]),
                    [attn.chunk_positions(s, c_len) for s in st], core,
                    moe_policy=moe_policy)
        out[d, 0] = _head(cfg, row, xs if every_row else
                          [_last_real_row(x, n) for x, n in zip(xs, ln)])
    return _gather_rows(mesh, out)


def mesh_paged_prefill_step(
    cfg: ArchConfig, lay: TPLayout, params: dict, cache: ShardedCache,
    inputs: torch.Tensor, start: torch.Tensor, block_tables: torch.Tensor,
    length: torch.Tensor, *, attn_impl: str = "kernel",
    moe_policy: str = "drop",
) -> torch.Tensor:
    """``models.paged_prefill_step`` over the mesh: inputs i32[S,C], start,
    length i32[S], block_tables i32[S,PB] (global ids) on the mesh's first
    device -> the logits of each row's last real chunk row [S,V] float32
    there; every shard's pool piece updated in place."""
    return _paged_chunk(cfg, lay, params, cache, inputs, start,
                        block_tables, length, attn_impl, every_row=False,
                        moe_policy=moe_policy)


def mesh_paged_verify_step(
    cfg: ArchConfig, lay: TPLayout, params: dict, cache: ShardedCache,
    inputs: torch.Tensor, start: torch.Tensor, block_tables: torch.Tensor,
    length: torch.Tensor, *, attn_impl: str = "kernel",
    moe_policy: str = "drop",
) -> torch.Tensor:
    """``models.paged_verify_step`` over the mesh (the ``vf`` lane): as
    ``mesh_paged_prefill_step``, but the logits of all C = k+1 window rows
    [S,C,V] float32, gathered over ``data`` onto the mesh's first
    device."""
    return _paged_chunk(cfg, lay, params, cache, inputs, start,
                        block_tables, length, attn_impl, every_row=True,
                        moe_policy=moe_policy)


def _dense_cores(row: _Row, cs: list, fn) -> list:
    """Run ``fn(m, cache)`` (write, then attend) on every shard's dense
    cache of one layer -> each shard's output. Where the sequence is split
    over ``model``, ``fn`` runs over the row's pieces gathered (all
    positions; the scales are whole on every shard), and each shard then
    copies its own positions back into its piece."""
    if not row.seq_split:
        return [fn(m, c) for m, c in enumerate(cs)]
    full = {n: row.gather([c[n] for c in cs], dim=1) for n in ("k", "v")}
    outs = []
    for m, c in enumerate(cs):
        whole = dict(c, k=full["k"][m], v=full["v"][m])
        outs.append(fn(m, whole))
        n = c["k"].shape[1]
        for name in ("k", "v"):
            c[name].copy_(whole[name][:, m * n:(m + 1) * n])
    return outs


@_per_device
def mesh_slot_decode_step(
    cfg: ArchConfig, lay: TPLayout, params: dict, cache: ShardedCache,
    inputs: torch.Tensor, pos: torch.Tensor, *, attn_impl: str = "kernel",
    moe_policy: str = "drop",
) -> torch.Tensor:
    """``models.decode_step`` at per-row positions over the mesh (the
    ``cb`` lane, and each of a ``dr`` call's steps): inputs i32[S,1], pos
    i32[S] on the mesh's first device -> logits [S,V] float32 there; every
    shard's dense cache piece updated in place."""
    mesh = cache.mesh
    out = {}
    for d, lo, hi, row in _rows(lay, mesh, params, cache):
        p = row.each(pos[lo:hi])

        def core(acfg, cs, qs, ks, vs, local, amax, p=p, row=row):
            return _dense_cores(row, cs, lambda m, c: attn.dense_decode_core(
                acfg, c, qs[m], ks[m], vs[m], p[m], local=local,
                attn_impl=attn_impl, amax=amax[m]))

        xs = _tower(cfg, row, row.each(inputs[lo:hi]),
                    [x[:, None] for x in p], core, moe_policy=moe_policy)
        out[d, 0] = _head(cfg, row, [x[:, -1] for x in xs])
    return _gather_rows(mesh, out)


@_per_device
def _dense_chunk(cfg, lay, params, cache, inputs, start, length,
                 attn_impl: str, every_row: bool,
                 moe_policy: str) -> torch.Tensor:
    """The dense chunk tower over the mesh -> the logits of each row's last
    real chunk row [S,V], or with ``every_row`` of every row [S,C,V]."""
    from .model import _last_real_row

    mesh = cache.mesh
    c_len = inputs.shape[1]
    smax = cache.shapes[0]["k"][2]
    if c_len > smax:
        raise ValueError(f"a chunk of {c_len} rows does not fit a dense "
                         f"cache of max_len={smax}")
    out = {}
    for d, lo, hi, row in _rows(lay, mesh, params, cache):
        st = row.each(start[lo:hi])
        ln = row.each(length[lo:hi])

        def core(acfg, cs, qs, ks, vs, local, amax, st=st, ln=ln, row=row):
            return _dense_cores(row, cs, lambda m, c: attn.dense_chunk_core(
                acfg, c, qs[m], ks[m], vs[m], st[m], ln[m], local=local,
                attn_impl=attn_impl, amax=amax[m]))

        xs = _tower(cfg, row, row.each(inputs[lo:hi]),
                    [attn.chunk_positions(s, c_len) for s in st], core,
                    moe_policy=moe_policy)
        out[d, 0] = _head(cfg, row, xs if every_row else
                          [_last_real_row(x, n) for x, n in zip(xs, ln)])
    return _gather_rows(mesh, out)


def mesh_slot_prefill_step(
    cfg: ArchConfig, lay: TPLayout, params: dict, cache: ShardedCache,
    inputs: torch.Tensor, start: torch.Tensor, length: torch.Tensor, *,
    attn_impl: str = "kernel", moe_policy: str = "drop",
) -> torch.Tensor:
    """``models.chunked_decode_step`` over the mesh (the ``pfd`` lane and
    the draft's ``drp``): inputs i32[S,C], start, length i32[S] on the
    mesh's first device -> the logits of each row's last real chunk row
    [S,V] float32 there; every shard's dense cache piece updated in
    place."""
    return _dense_chunk(cfg, lay, params, cache, inputs, start, length,
                        attn_impl, every_row=False, moe_policy=moe_policy)


def mesh_slot_verify_step(
    cfg: ArchConfig, lay: TPLayout, params: dict, cache: ShardedCache,
    inputs: torch.Tensor, start: torch.Tensor, length: torch.Tensor, *,
    attn_impl: str = "kernel", moe_policy: str = "drop",
) -> torch.Tensor:
    """``models.chunked_verify_step`` over the mesh (the ``vfd`` lane):
    the logits of all C = k+1 window rows [S,C,V] float32 on the mesh's
    first device."""
    return _dense_chunk(cfg, lay, params, cache, inputs, start, length,
                        attn_impl, every_row=True, moe_policy=moe_policy)


def _gather_rows(mesh, out: dict) -> torch.Tensor:
    """The rows' outputs (``{row's first coordinate: [b, ...]}``)
    concatenated in row order on the mesh's first device: the
    ``all_gather`` over ``data``, then over ``pod`` where the mesh has one
    (rows ``pod`` major)."""
    for axis in ("data", "pod"):
        if axis in mesh.axis_names:
            out = coll.all_gather(out, mesh, axis, dim=0, tiled=True)
    first = mesh.coords()[0]
    return out[first].to(mesh.device(first))
