"""The JAX package's SPMD steps over a mesh of logical devices with the full
sharding rules: the training loss, ``prefill`` and ``decode`` (ROADMAP A12
part 3 items 4-5; the bodies of ``runtime.steps.lower_train``,
``lower_prefill`` and ``lower_decode``).

Each coordinate computes with its model shard of every weight, whole over
``data`` (``distributed.fsdp.gather_params``): the tower of
``models.tensor_parallel`` (``_Row``, ``_tower``; MLP or MoE tails, the
MoE under ``moe_policy``) runs on each data row's shards, with the
collectives over ``model`` where GSPMD puts them. Inputs are tokens, or an
embeddings arch's ``[B, S, D]`` (``[B, 1, D]`` in decode), replicated over
``model``. The
batch is split over the rows of ``("pod", "data")`` (row ``r`` of ``R``
takes batch rows ``[r·B/R, (r+1)·B/R)``, as ``sharding.data_pspec`` lays
it out), and it must divide over them. The attention is the plain one
(``"naive"`` or ``"chunked"``): the kernels refuse a gradient, and the JAX
package's lowered steps reach no Pallas kernel.

**The loss** is the global mean. Each row reduces its cross-entropy sum and
its valid-token count, and only those scalars cross rows (``all_reduce``
over ``data``, then ``pod``), then one division: a mean of the rows' means
would be wrong where the rows hold different numbers of pads. The MoE
load-balancing term is the JAX package's ``Σ me·ce · E/k`` with ``me`` and
``ce`` means over the **global** batch: each row's ``[E]`` sums
(``moe.aux_stats``) are reduced over the rows before the product (a mean
of the rows' terms would be another number). Every model shard of a row
computes it alike from the replicated router outputs, and it enters the
loss as the cross-entropy does: each coordinate adds its copy, and the
gradient is taken of the first coordinate's loss only, so it reaches the
router once. Where the
head splits the vocab over ``model``, the loss is vocab-parallel: each
shard's logsumexp pieces combine by ``pmax`` and ``all_reduce``, and the
label's logit comes from the shard that owns it, so no ``[B, S, V]``
logits are gathered (as GSPMD partitions the JAX package's logsumexp).

**Full-sequence attention** (the loss and prefill) lays its queries out as
the JAX package's ``hint_attn_q``: by heads where ``model`` divides them,
else, under ``perf.seq_shard_fallback`` where ``model`` divides the
sequence, by query rows (``sharding.attn_q_split``; each shard attends its
``S / mp`` rows at their global positions over the whole K/V and the rows
are joined by an ``all_gather`` over ``model``,
``tensor_parallel._attend_rows``), else whole on every shard. Decode never
reads the flag, as the JAX package's does not.

**Prefill** emits the dense cache in ``sharding.cache_pspec_tree``'s
layout (batch over the rows, sequence over ``model``, every kv head):
where a shard computed some of the kv heads, the row's heads are joined
over ``model`` and each shard keeps its positions. **Decode** runs on that
layout through ``tensor_parallel``'s sequence-split path
(``_dense_cores``): each shard gathers its row's cache over ``model``,
writes the new K/V row (joined over ``model`` where the heads are split)
and attends with its query heads over every position, then keeps its
positions.

**On a mesh of ``meta`` devices** (the dry run) every row computes the same
shapes and no values, so only the first row runs the towers (``ran``),
and each other coordinate takes a copy of the first row's result at its
model index (``stand_in``): its loss pieces, logits and cache pieces. A
capture report then counts the towers 1/``mp`` to a device (``row_spread``)
where a run on real devices counts every row's 1/devices: the same
per-device work, in a sixteenth of the time on the 16 x 16 production
mesh.

SSM and hybrid stacks raise ``NotImplementedError``
(``tensor_parallel.check_family``).
"""

from __future__ import annotations

import itertools

import torch

from repro_torch import capture_analysis, perf
from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd

from . import attention as attn
from . import moe as moe_mod
from . import tensor_parallel as tp
from .model import MOE_AUX_WEIGHT, _positions

TRAIN_IMPLS = ("naive", "chunked")


def check_mesh(mesh) -> None:
    """The steps run on meshes of ``("data", "model")`` or ``("pod",
    "data", "model")``."""
    if mesh.axis_names not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"a mesh of axes ('data', 'model') or ('pod', "
                         f"'data', 'model') is needed, got {mesh.axis_names}")


def layout(cfg: ArchConfig, uspecs: dict, mesh) -> tp.TPLayout:
    """What the use specs (``fsdp.use_specs``) split over ``model``."""
    def split(key: str) -> bool:
        return key in uspecs and shd.splits(uspecs[key], "model")

    vocab, width = tp.vocab_split(cfg, uspecs)
    return tp.TPLayout(
        dp=num_rows(mesh), mp=mesh.shape["model"],
        heads=split("blocks.0.attn.wq"), kv=split("blocks.0.attn.wk"),
        mlp=split("blocks.0.mlp.w_gate"), moe=moe_mod.moe_split(uspecs),
        vocab=vocab, width=width, rows=(), row_block=0)


def num_rows(mesh) -> int:
    return mesh.size // mesh.shape["model"]


def rows(mesh) -> list[list[tuple]]:
    """Each row's coordinates (one per model index), rows in batch order
    (``pod`` major)."""
    lead = [range(mesh.shape[a]) for a in mesh.axis_names[:-1]]
    return [[r + (m,) for m in range(mesh.shape["model"])]
            for r in itertools.product(*lead)]


def _row_slice(t: torch.Tensor, r: int, n: int) -> torch.Tensor:
    b = t.shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} rows does not divide over the "
                         f"mesh's {n} rows of ('pod', 'data')")
    return t[r * (b // n):(r + 1) * (b // n)]


def symmetric(mesh) -> bool:
    """Whether only the first row runs (every device ``meta``)."""
    return all(d.type == "meta" for d in mesh.devices)


def ran(mesh) -> list[tuple]:
    """The coordinates that run the towers."""
    rs = rows(mesh)
    return rs[0] if symmetric(mesh) else [c for r in rs for c in r]


def stand_in(mesh, c: tuple) -> tuple:
    """The coordinate whose tower result ``c`` takes (itself, or the first
    row's at its model index)."""
    return rows(mesh)[0][c[-1]] if symmetric(mesh) else c


def row_spread(mesh):
    """The capture report's ``spread`` of the towers' work (and of their
    backward): 1/``mp`` where only the first row runs, else 1/devices."""
    return capture_analysis.spread(
        mesh.shape["model"] if symmetric(mesh) else mesh.size)


def _copies(mesh, out: dict, model0: bool = False) -> dict:
    """``out`` (a tensor per coordinate that ran; with ``model0`` per row,
    at model index 0) with every other coordinate's (row's) copy of its
    stand-in's."""
    return {c: out[c] if c in out else out[stand_in(mesh, c)].clone()
            for c in mesh.coords() if not (model0 and c[-1])}


def _rows_of(cfg, mesh, params: dict, uspecs: dict, cache=None,
             seq: int | None = None):
    """(row index, ``tensor_parallel._Row``) for every row that runs; with
    ``seq`` (full-sequence attention over that many rows) the rows split
    their queries where ``sharding.attn_q_split`` says "seq"."""
    lay = layout(cfg, uspecs, mesh)
    seq_q = seq is not None and shd.attn_q_split(
        cfg.num_heads, seq, lay.mp) == "seq"
    run = rows(mesh)[:1] if symmetric(mesh) else rows(mesh)
    for r, coords in enumerate(run):
        yield r, tp._Row(lay, mesh, params, cache, r, coords=coords,
                         seq_q=seq_q)


def full_core(impl: str):
    """The cacheless core of a training forward: causal attention of each
    shard's heads over its row's whole sequence; with ``offsets`` (a
    ``seq_q`` row) each shard's queries start at its offset."""
    if impl not in TRAIN_IMPLS:
        raise ValueError(f"impl must be one of {TRAIN_IMPLS} on a mesh (the "
                         f"kernels refuse a gradient), got {impl!r}")

    def core(acfg, cs, qs, ks, vs, local, amax, offsets=None):
        window = acfg.sliding_window if local else None
        outs = []
        for q, k, v, off in zip(qs, ks, vs, offsets or [0] * len(qs)):
            b, s, h, dh = q.shape
            qg = attn._group(acfg, q)
            if impl == "chunked":
                og = attn._sdpa_chunked(acfg, qg, k, v, window=window,
                                        block=perf.current().attn_block,
                                        q_offset=off)
            else:
                og = attn._sdpa_naive(acfg, qg, k, v, window=window,
                                      q_offset=off)
            outs.append(og.reshape(b, s, h, dh))
        return outs

    return core


def _row_ce(cfg: ArchConfig, row, xs: list, labels: torch.Tensor) -> list:
    """Each shard's copy of the row's cross-entropy per token ``[b, S]``
    (0 at a pad): vocab-parallel where the head splits the vocab."""
    logits = tp._shard_logits(cfg, row, xs)
    labs = row.each(labels)
    safe = [torch.clamp(t, min=0).long() for t in labs]
    if not row.lay.vocab:
        lse = [torch.logsumexp(t, dim=-1) for t in logits]
        ll = [torch.gather(t, -1, s[..., None])[..., 0]
              for t, s in zip(logits, safe)]
    else:
        top = row.pmax([t.detach().amax(dim=-1) for t in logits])
        sums = row.reduce([torch.exp(t - mx[..., None]).sum(dim=-1)
                           for t, mx in zip(logits, top)])
        lse = [mx + torch.log(s) for mx, s in zip(top, sums)]
        own = []
        for m, (t, s) in enumerate(zip(logits, safe)):
            n = t.shape[-1]
            ids = s - m * n
            ok = (ids >= 0) & (ids < n)
            got = torch.gather(t, -1, torch.where(ok, ids, 0)[..., None])
            own.append(torch.where(ok, got[..., 0], 0.0))
        ll = row.reduce(own)
    return [(z - y) * (lab >= 0).to(torch.float32)
            for z, y, lab in zip(lse, ll, labs)]


def _across_rows(xs: dict, mesh) -> dict:
    """The sum over the rows (``all_reduce`` over ``data``, then ``pod``)."""
    for axis in ("data", "pod"):
        if axis in mesh.axis_names:
            xs = coll.all_reduce(xs, mesh, axis)
    return xs


def mesh_loss(cfg: ArchConfig, mesh, params: dict, uspecs: dict,
              batch: dict, *, impl: str = "naive", moe_policy: str = "drop",
              remat: bool = False) -> tuple[dict, dict]:
    """The loss of ``batch`` (global ``inputs`` i32[B, S] and ``labels``,
    -1 = pad) over the mesh with each coordinate's weights ``params``
    (``{coord: {key: piece}}`` in the ``uspecs`` layout) -> (``{coord:
    loss}``, the first coordinate's ``{"ce", "moe_aux", "ntok"}``), as
    ``models.loss_fn``'s."""
    tp.check_family(cfg)
    check_mesh(mesh)
    core = full_core(impl)
    n = num_rows(mesh)
    moe = any(cfg.mlp_at(s) == "moe" for s in range(cfg.period))
    ce_sum, ntok, stats = {}, {}, {}
    with row_spread(mesh):
        for r, row in _rows_of(cfg, mesh, params, uspecs,
                               seq=batch["inputs"].shape[1]):
            toks = _row_slice(batch["inputs"], r, n)
            labels = _row_slice(batch["labels"], r, n)
            layers: list = []  # each MoE layer's shards' aux sums
            xs = tp._tower(cfg, row, row.each(toks),
                           [_positions(t) for t in row.each(toks)], core,
                           remat=remat, moe_policy=moe_policy, aux=layers)
            for m, (c, ce, lab) in enumerate(zip(
                    row.coords, _row_ce(cfg, row, xs, labels),
                    row.each(labels))):
                ce_sum[c] = torch.sum(ce)
                ntok[c] = torch.sum((lab >= 0).to(torch.float32))
                if moe:  # [layers, 2, E]: this shard's sums of the row
                    stats[c] = torch.stack([layer[m] for layer in layers])
        ce_sum, ntok = _copies(mesh, ce_sum), _copies(mesh, ntok)
        stats = _copies(mesh, stats) if moe else {}
    ce_sum, ntok = _across_rows(ce_sum, mesh), _across_rows(ntok, mesh)
    loss = {c: ce_sum[c] / torch.clamp(ntok[c], min=1.0) for c in ce_sum}
    if moe:  # the global batch's sums, then the product
        tokens = batch["inputs"].shape[0] * batch["inputs"].shape[1]
        aux = {c: moe_mod.aux_from_stats(cfg, t, tokens)
               for c, t in _across_rows(stats, mesh).items()}
    else:
        aux = {c: torch.zeros((), dtype=torch.float32, device=v.device)
               for c, v in loss.items()}
    total = {c: v + MOE_AUX_WEIGHT * aux[c] for c, v in loss.items()}
    first = mesh.coords()[0]
    return total, {"ce": loss[first], "moe_aux": aux[first],
                   "ntok": torch.clamp(ntok[first], min=1.0)}


def _seq_pieces(row, full: list, seq_split: bool) -> list:
    """Each shard's piece of a row's ``[b, S, KH, dh]`` tensor in the
    cache layout: its ``S / mp`` positions where the sequence splits."""
    if not seq_split:
        return full
    n = full[0].shape[1] // row.lay.mp
    return [t[:, m * n:(m + 1) * n] for m, t in enumerate(full)]


def mesh_prefill(cfg: ArchConfig, mesh, params: dict, uspecs: dict,
                 inputs: torch.Tensor, cache_specs: list, *,
                 impl: str = "naive", moe_policy: str = "drop") -> tuple:
    """``models.prefill`` over the mesh: ``inputs`` i32[B, S] (or an
    embeddings arch's [B, S, D]) -> (the last token's logits [B, V] float32
    on the mesh's first device, the dense cache as a
    ``tensor_parallel.ShardedCache`` in ``cache_specs``' layout)."""
    tp.check_family(cfg)
    check_mesh(mesh)
    n = num_rows(mesh)
    b, s = inputs.shape[0] // n, inputs.shape[1]
    seq_split = "model" in shd.spec_axes(cache_specs[0]["k"][2])
    layers = cfg.num_layers // cfg.period
    kept: dict = {c: [{"k": [], "v": []} for _ in range(cfg.period)]
                  for c in ran(mesh)}
    logits = {}
    base = full_core(impl)
    with row_spread(mesh):
        for r, row in _rows_of(cfg, mesh, params, uspecs, seq=s):
            calls = iter(range(layers * cfg.period))

            def core(acfg, cs, qs, ks, vs, local, amax, offsets=None,
                     row=row, calls=calls):
                slot = next(calls) % cfg.period
                whole = (ks, vs)
                if ks[0].shape[2] < cfg.num_kv_heads:  # the heads joined
                    whole = (row.gather(ks, dim=2), row.gather(vs, dim=2))
                for name, full in zip(("k", "v"), whole):
                    for c, t in zip(row.coords,
                                    _seq_pieces(row, full, seq_split)):
                        kept[c][slot][name].append(t)
                return base(acfg, cs, qs, ks, vs, local, amax, offsets)

            toks = _row_slice(inputs, r, n)
            xs = tp._tower(cfg, row, row.each(toks),
                           [_positions(t) for t in row.each(toks)], core,
                           moe_policy=moe_policy)
            logits[row.coords[0]] = tp._head(cfg, row,
                                             [x[:, -1] for x in xs])
        logits = _copies(mesh, logits, model0=True)
    with capture_analysis.spread(mesh.size):
        shards = {c: [{name: torch.stack(ts).contiguous()
                       for name, ts in slot.items()}
                      for slot in kept[stand_in(mesh, c)]]
                  for c in mesh.coords()}
    shapes = [{name: (layers, b * n, s, cfg.num_kv_heads, cfg.head_dim)
               for name in ("k", "v")} for _ in range(cfg.period)]
    cache = tp.ShardedCache(mesh, shards, cache_specs, shapes, b,
                            seq_split=seq_split)
    return tp._gather_rows(mesh, logits), cache


def mesh_decode(cfg: ArchConfig, mesh, params: dict, uspecs: dict,
                cache: "tp.ShardedCache", inputs: torch.Tensor,
                pos: torch.Tensor, *, moe_policy: str = "drop"
                ) -> torch.Tensor:
    """``models.decode_step`` over the mesh: ``inputs`` i32[B, 1] (or an
    embeddings arch's [B, 1, D]) and one position ``pos`` (0-d, every
    row's) -> logits [B, V] float32 on the mesh's first device; every
    coordinate's cache piece (the ``cache_pspec_tree`` layout) updated in
    place."""
    tp.check_family(cfg)
    check_mesh(mesh)
    with row_spread(mesh):
        logits = _decode_rows(cfg, mesh, params, uspecs, cache, inputs, pos,
                              moe_policy)
    return tp._gather_rows(mesh, logits)


def _decode_rows(cfg, mesh, params, uspecs, cache, inputs, pos,
                 moe_policy) -> dict:
    n = num_rows(mesh)
    logits = {}
    for r, row in _rows_of(cfg, mesh, params, uspecs, cache):
        toks = _row_slice(inputs, r, n)
        p = row.each(pos.reshape(1).expand(toks.shape[0]).to(torch.int32))

        def core(acfg, cs, qs, ks, vs, local, amax, row=row, p=p):
            heads = ks[0].shape[2]
            if heads < cs[0]["k"].shape[2]:  # the new row's heads joined
                ks, vs = row.gather(ks, dim=2), row.gather(vs, dim=2)

            def write_attend(m, c):
                smax = c["k"].shape[1]
                at = torch.arange(p[m].shape[0], device=p[m].device)
                attn._put_rows(c, at, p[m].clamp(max=smax - 1).long(),
                               p[m] < smax, ks[m][:, 0], vs[m][:, 0], None)
                lo = m * heads if heads < c["k"].shape[2] else 0
                return attn._decode_sdpa_core(
                    acfg, qs[m], c["k"][:, :, lo:lo + heads],
                    c["v"][:, :, lo:lo + heads], p[m], local=local)

            return tp._dense_cores(row, cs, write_attend)

        xs = tp._tower(cfg, row, row.each(toks), [x[:, None] for x in p],
                       core, moe_policy=moe_policy)
        logits[row.coords[0]] = tp._head(cfg, row, [x[:, -1] for x in xs])
    return _copies(mesh, logits, model0=True)
