"""Step builders for the dense and paged serving lanes, the speculative
lanes, the per-burst engine, full-sequence prefill and training (counterpart
of ``repro.runtime.steps``).

A step is a plain function over tensors; ``runtime.serve.Engine`` binds it to
a dispatch key's static shapes. Every builder takes the attention
implementation and, for a MoE stack, the dispatch policy (``moe_policy``,
``models.moe``), both baked into the step. Each step ends with its *bundle*: the next
step's chained input and one packed int32 tensor of every host-bound output,
so the serving loop pays exactly one device-to-host transfer per step.

A sampling step takes per-row threefry keys ``keys [S, 2]`` (uint32 bits
stored as int32) and returns them split, as the JAX package's steps do:
each row's key is split in 2, the first half draws the row's categorical
sample and the second is its next key (``_sample_rows``). The keys chain
through the step like the next token and position — with graphs, inside
the target's own inputs — so a CUDA graph replays no random state of its
own, and the sampled streams equal the JAX package's token for token. On
the card the tail is one launch of ``kernels.sampling.sample_rows``; on the
CPU it is its plain version, ``repro_torch.prng``.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import capture_analysis, models, perf
from repro_torch.configs import ArchConfig, ShapeSpec
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import sampling
from repro_torch.models import input_specs, spmd, tensor_parallel
from repro_torch.optim import adamw


def _sample_rows(
    logits: torch.Tensor,
    temps: torch.Tensor,
    greedy: torch.Tensor,
    keys: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sampling as data (DESIGN.md §4): per-row greedy flag and temperature,
    so a mode flip never touches the cold path. Each row's key is split in
    2: a sampled row draws ``categorical(first half, logits / t)``, a greedy
    row takes the argmax. Returns (next tokens i32[S], new keys i32[S, 2])
    (``kernels.sampling.sample_rows``)."""
    return sampling.sample_rows(logits, temps, greedy, keys)


def _step_bundle(nxt: torch.Tensor, new_pos: torch.Tensor,
                 new_keys: torch.Tensor):
    """``tok_col [S,1]`` (the chained next-step input) and ``packed [S,4]``
    (``[next_tok | new_pos | new_keys]``, the step's one d2h transfer)."""
    tok_col = nxt[:, None]
    return tok_col, torch.cat([tok_col, new_pos[:, None], new_keys], dim=1)


def pack_step_d2h(nxt: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """``[S]`` next tokens + ``[S,2]`` keys -> one ``[S,3]`` int32 tensor:
    a prefill chunk's single d2h transfer."""
    return torch.cat([nxt[:, None], keys], dim=1)


def pack_verify_d2h(rows: torch.Tensor, nxt0: torch.Tensor,
                    keys: torch.Tensor) -> torch.Tensor:
    """``[S,K+1]`` verify rows + ``[S]`` row-0 samples + ``[S,2]`` keys ->
    one ``[S,K+4]`` int32 tensor: the verify step's single d2h transfer."""
    return torch.cat([rows, nxt0[:, None], keys], dim=1)


def make_decode_fn(cfg: ArchConfig, *, attn_impl: str = "kernel",
                   moe_policy: str = "drop") -> Callable:
    """Plain decode step over the dense cache:

        step(params, cache, inputs[B,1], pos) -> (logits[B,V], cache)"""

    def serve_step(params, cache, inputs, pos):
        return models.decode_step(
            cfg, params, cache, inputs, pos, attn_impl=attn_impl,
            moe_policy=moe_policy,
        )

    return serve_step


def make_sampling_decode_fn(
    cfg: ArchConfig,
    *,
    mode: int,
    temperature: float = 1.0,
    attn_impl: str = "kernel",
    moe_policy: str = "drop",
) -> Callable:
    """Decode step with the sampling mode *baked into the target* — the
    per-burst engine's branch targets, one per ``("burst", bucket, mode)``
    key (DESIGN.md §2):

        step(params, cache, inputs[B,1], pos, key[2])
          -> (tok[B], cache, tok_col[B,1], new_pos)

    ``pos`` is a 0-dim int32 device tensor (every row at one position);
    ``tok_col`` and ``new_pos = pos + 1`` are the next step's inputs. For
    an embeddings arch ``inputs`` is ``[B,1,D]`` in the model dtype and
    stands in for ``tok_col``: a sampled id has no embedding to feed back
    (``Engine.decode_loop`` takes one step there).
    ``mode`` 0 = greedy (argmax; the key is ignored), 1 = a sample at
    ``temperature``: ``categorical(key, logits / temperature)`` with one
    key over the whole ``[B, V]``, as the JAX package's step draws it
    (``kernels.sampling.categorical_rows``). Flipping mode means
    dispatching another target: cheap once built, but a build on first
    sight and a slot rebind per flip."""
    if mode not in (0, 1):
        raise ValueError(f"mode must be 0 (greedy) or 1 (sample), got {mode}")
    decode = make_decode_fn(cfg, attn_impl=attn_impl, moe_policy=moe_policy)
    tokens = cfg.input_kind == "tokens"

    def step(params, cache, inputs, pos, key):
        logits, cache = decode(params, cache, inputs, pos)
        if mode == 0:
            nxt = logits.argmax(dim=-1).to(torch.int32)
        else:
            nxt = sampling.categorical_rows(key, logits, temperature)
        return nxt, cache, nxt[:, None] if tokens else inputs, pos + 1

    return step


def make_prefill_fn(cfg: ArchConfig, *, impl: str = "kernel",
                    moe_policy: str = "drop") -> Callable:
    """Full-prompt prefill: ``step(params, inputs[B,S]) -> (logits[B,V],
    cache [m,B,S,KH,dh] per slot, or a mamba slot's {conv, state})``;
    ``impl`` as ``models.prefill`` (B6 and B8 with ``"kernel"``)."""

    def prefill_step(params, inputs):
        return models.prefill(cfg, params, inputs, impl=impl,
                              moe_policy=moe_policy)

    return prefill_step


def _decode_logits(one: Callable, mesh: Callable, cfg: ArchConfig,
                   attn_impl: str, moe_policy: str,
                   layout: tensor_parallel.TPLayout | None) -> Callable:
    """A step's logits ``(params, cache, *inputs)``: the one-device model
    function ``one`` (its cache updated in place) or, with a mesh
    ``layout``, its counterpart ``mesh`` in ``models.tensor_parallel``."""
    if layout is not None:
        return partial(mesh, cfg, layout, attn_impl=attn_impl,
                       moe_policy=moe_policy)

    def logits(params, cache, *inputs):
        return one(cfg, params, cache, *inputs, attn_impl=attn_impl,
                   moe_policy=moe_policy)[0]

    return logits


def make_slot_decode_fn(
    cfg: ArchConfig, *, attn_impl: str = "kernel", moe_policy: str = "drop",
    layout: tensor_parallel.TPLayout | None = None,
) -> Callable:
    """Dense continuous-batching decode step, the ``("cb", slots)`` key
    (DESIGN.md §4): sampling params are data, not code.

        step(params, cache, tok[S,1], pos[S], active[S], temps[S],
             greedy[S], keys[S,2])
          -> (next_tok[S], cache, new_pos[S], new_keys[S,2], tok_col[S,1],
              packed[S,4])

    Each slot sits at its own depth ``pos`` of the dense per-slot cache;
    inactive slots still compute (fixed shapes) but their positions do not
    advance. ``keys`` are split in the step (``_sample_rows``); ``packed``
    is ``[next_tok | new_pos | new_keys]``, the step's one pull. A mesh
    ``layout`` as in ``make_paged_slot_decode_fn``, over the mesh's dense
    cache."""
    decode = _decode_logits(models.decode_step,
                            tensor_parallel.mesh_slot_decode_step, cfg,
                            attn_impl, moe_policy, layout)

    def slot_step(params, cache, tok, pos, active, temps, greedy, keys):
        logits = decode(params, cache, tok, pos)
        nxt, new_keys = _sample_rows(logits, temps, greedy, keys)
        new_pos = pos + active.to(torch.int32)
        return (nxt, cache, new_pos, new_keys,
                *_step_bundle(nxt, new_pos, new_keys))

    return slot_step


def make_paged_slot_decode_fn(
    cfg: ArchConfig, *, attn_impl: str = "kernel", moe_policy: str = "drop",
    layout: tensor_parallel.TPLayout | None = None,
) -> Callable:
    """Paged continuous-batching decode step (DESIGN.md §9):

        step(params, cache, tok[S,1], pos[S], block_tables[S,PB], active[S],
             temps[S], greedy[S], keys[S,2])
          -> (next_tok[S], cache, new_pos[S], new_keys[S,2], tok_col[S,1],
              packed[S,4])

    Inactive slots carry all-null block tables, so their writes land in the
    null page; their positions do not advance. With a mesh ``layout``
    (``models.tensor_parallel``) ``params`` are the mesh's per-coordinate
    weights and ``cache`` its ``ShardedCache``: each data row's shards run
    every layer on its slots, and the gathered logits are sampled once on
    the mesh's first device, where the rows live."""

    decode = _decode_logits(models.paged_decode_step,
                            tensor_parallel.mesh_paged_decode_step, cfg,
                            attn_impl, moe_policy, layout)

    def paged_slot_step(
        params, cache, tok, pos, block_tables, active, temps, greedy, keys
    ):
        logits = decode(params, cache, tok, pos, block_tables)
        nxt, new_keys = _sample_rows(logits, temps, greedy, keys)
        new_pos = pos + active.to(torch.int32)
        return (nxt, cache, new_pos, new_keys,
                *_step_bundle(nxt, new_pos, new_keys))

    return paged_slot_step


def _chunk_sample(logits, length, temps, greedy, keys):
    """A chunk step's tail: the last real row's sample, the keys split —
    but idle rows (``length`` 0, bucket padding) keep theirs unsplit, so
    the keys a chunk returns can be adopted wholesale (the JAX package's
    rule) — and the packed ``[S,3]`` pull."""
    nxt, new_keys = _sample_rows(logits, temps, greedy, keys)
    new_keys = torch.where(length[:, None] > 0, new_keys, keys)
    return nxt, new_keys, pack_step_d2h(nxt, new_keys)


def make_paged_prefill_fn(
    cfg: ArchConfig, *, attn_impl: str = "kernel", moe_policy: str = "drop",
    layout: tensor_parallel.TPLayout | None = None,
) -> Callable:
    """Chunked-prefill step through the paged KV cache (DESIGN.md §10):

        step(params, cache, tok[B,CB], start[B], block_tables[B,PB],
             length[B], temps[B], greedy[B], keys[B,2])
          -> (next_tok[B], cache, new_keys[B,2], packed[B,3])

    ``next_tok`` is sampled from each row's last real chunk token and primes
    generation when the chunk reaches the prompt end. Columns >= ``length``
    are bucket padding: their K/V writes land in the null page; a row of
    length 0 keeps its key (``_chunk_sample``). A mesh ``layout`` as in
    ``make_paged_slot_decode_fn``."""

    prefill = _decode_logits(models.paged_prefill_step,
                             tensor_parallel.mesh_paged_prefill_step, cfg,
                             attn_impl, moe_policy, layout)

    def paged_prefill_step(
        params, cache, tok, start, block_tables, length, temps, greedy, keys,
    ):
        logits = prefill(params, cache, tok, start, block_tables, length)
        nxt, new_keys, packed = _chunk_sample(logits, length, temps, greedy,
                                              keys)
        return nxt, cache, new_keys, packed

    return paged_prefill_step


def _verify_tail(logits, temps, greedy, keys):
    """The verify lanes' tail: greedy rows, row 0's mode-respecting sample
    (one key split, as a decode step), the packed ``[S,K+4]`` pull."""
    rows = logits.argmax(dim=-1).to(torch.int32)
    nxt0, new_keys = _sample_rows(logits[:, 0], temps, greedy, keys)
    return rows, nxt0, new_keys, pack_verify_d2h(rows, nxt0, new_keys)


def make_paged_verify_fn(
    cfg: ArchConfig, *, attn_impl: str = "kernel", moe_policy: str = "drop",
    layout: tensor_parallel.TPLayout | None = None,
) -> Callable:
    """Verify lane through the paged KV cache (DESIGN.md §11):

        step(params, cache, tok[S,K+1], start[S], block_tables[S,PB],
             length[S], temps[S], greedy[S], keys[S,2])
          -> (rows[S,K+1], next0[S], cache, new_keys[S,2], packed[S,K+4])

    ``tok`` is each slot's current token followed by its K draft
    candidates; all K+1 positions are scored in one target pass through the
    chunk path (columns >= ``length`` write only the null page).
    ``rows[s, i]`` is the greedy continuation after rows 0..i — acceptance
    and the correction token are host-side comparisons over it. ``next0``
    is the mode-respecting sample from row 0 (one key split, as a decode
    step), so a length-1 window is a decode step and sampling slots ride
    the same call. ``packed`` is ``pack_verify_d2h(rows, next0,
    new_keys)``. A mesh ``layout`` as in ``make_paged_slot_decode_fn``:
    the window's logits are gathered onto the mesh's first device."""
    verify = _decode_logits(models.paged_verify_step,
                            tensor_parallel.mesh_paged_verify_step, cfg,
                            attn_impl, moe_policy, layout)

    def verify_step(
        params, cache, tok, start, block_tables, length, temps, greedy, keys,
    ):
        logits = verify(params, cache, tok, start, block_tables, length)
        rows, nxt0, new_keys, packed = _verify_tail(logits, temps, greedy,
                                                    keys)
        return rows, nxt0, cache, new_keys, packed

    return verify_step


def make_slot_verify_fn(
    cfg: ArchConfig, *, attn_impl: str = "kernel", moe_policy: str = "drop",
    layout: tensor_parallel.TPLayout | None = None,
) -> Callable:
    """Verify lane over the dense per-slot cache, the ``("vfd", slots,
    k_bucket)`` key (DESIGN.md §11):

        step(params, cache, tok[S,K+1], start[S], length[S], temps[S],
             greedy[S], keys[S,2])
          -> (rows[S,K+1], next0[S], cache, new_keys[S,2], packed[S,K+4])

    ``make_paged_verify_fn`` without block tables: a dense slot's cache
    rows are a trivial identity block table, so both engines share the
    accept/rollback contract (columns >= ``length`` write nothing). A mesh
    ``layout`` as in ``make_slot_decode_fn``."""
    verify = _decode_logits(models.chunked_verify_step,
                            tensor_parallel.mesh_slot_verify_step, cfg,
                            attn_impl, moe_policy, layout)

    def verify_step(params, cache, tok, start, length, temps, greedy, keys):
        logits = verify(params, cache, tok, start, length)
        rows, nxt0, new_keys, packed = _verify_tail(logits, temps, greedy,
                                                    keys)
        return rows, nxt0, cache, new_keys, packed

    return verify_step


def make_draft_fn(
    draft_cfg: ArchConfig, *, k: int, attn_impl: str = "kernel",
    moe_policy: str = "drop",
    layout: tensor_parallel.TPLayout | None = None,
) -> Callable:
    """Draft lane (DESIGN.md §11): K candidates per slot in one branch
    target, the ``("dr", slots, k_bucket, draft_kv_dtype)`` key:

        step(draft_params, draft_cache, tok[S,1], pos[S], active[S],
             temps[S], greedy[S], keys[S,2])
          -> (drafts[S,K], draft_cache, new_pos[S], new_keys[S,2])

    ``draft_cfg``/``draft_params`` are the truncated-layer view
    (``models.draft_view``), ``draft_cache`` its dense per-slot cache,
    attended by B1 (B3 on an int8 cache) over its page view with
    ``attn_impl="kernel"``. The K decode steps loop inside the target, so k
    is fixed when it is built; each step feeds the previous candidate back
    and writes the draft's KV at the advancing position (the scheduler
    later rewinds ``pos`` as data and the next round overwrites a rejected
    tail). Every step samples through ``_sample_rows``, splitting the keys,
    as the JAX package's draft does; the scheduler forces ``greedy`` on, so
    the candidates are argmaxes, and discards the returned keys, so the
    sampled streams are untouched. With a mesh ``layout`` each of the k
    steps runs over the mesh (the draft's shards and dense cache), its
    logits gathered and sampled once on the mesh's first device, and the
    candidate goes back to the rows."""
    decode = _decode_logits(models.decode_step,
                            tensor_parallel.mesh_slot_decode_step, draft_cfg,
                            attn_impl, moe_policy, layout)

    def draft_step(params, cache, tok, pos, active, temps, greedy, keys):
        drafts = []
        for _ in range(k):
            logits = decode(params, cache, tok, pos)
            nxt, keys = _sample_rows(logits, temps, greedy, keys)
            drafts.append(nxt)
            tok = nxt[:, None]
            pos = pos + active.to(torch.int32)
        return torch.stack(drafts, dim=1), cache, pos, keys

    return draft_step


def make_slot_prefill_fn(
    cfg: ArchConfig, *, attn_impl: str = "kernel", moe_policy: str = "drop",
    layout: tensor_parallel.TPLayout | None = None,
) -> Callable:
    """Chunked prefill into the dense per-slot cache (DESIGN.md §10): the
    dense engine's prompt path, the ``("pfd", slots, chunk_bucket)`` key,
    and the draft's prompt mirror, the ``("drp", slots, chunk_bucket,
    draft_kv_dtype)`` key:

        step(params, cache, tok[S,CB], start[S], length[S], temps[S],
             greedy[S], keys[S,2])
          -> (next_tok[S], cache, new_keys[S,2], packed[S,3])

    Every slot carries its own chunk window (``length`` 0 = idle row,
    writes nothing and keeps its key); attention is B2 (B4 on an int8
    cache) over the cache's page view with ``attn_impl="kernel"``.
    ``next_tok`` is sampled from each row's last real chunk token; the
    mirror discards its sample and keys, so it never moves the sampled
    streams. A mesh ``layout`` as in ``make_slot_decode_fn``."""
    prefill = _decode_logits(models.chunked_decode_step,
                             tensor_parallel.mesh_slot_prefill_step, cfg,
                             attn_impl, moe_policy, layout)

    def slot_prefill_step(params, cache, tok, start, length, temps, greedy,
                          keys):
        logits = prefill(params, cache, tok, start, length)
        nxt, new_keys, packed = _chunk_sample(logits, length, temps, greedy,
                                              keys)
        return nxt, cache, new_keys, packed

    return slot_prefill_step


# -------------------------------------------- KV-page migration transport
# Disaggregated prefill/decode (DESIGN.md §17) moves a request's KV pages
# between two pools when its slot flips PREFILL -> DECODE. The unit is a
# page-index bucket: gather B pages out of every leaf of the source pool
# ([m, P, page_size, ...], page axis 1; the int8 scale leaves share it), move
# the block to the destination's device, scatter it into the destination
# pool in place. ``idx`` is padded with the pools' null page, so a short
# migration reads and writes only that reserved page: the shapes never
# change and each (kv_dtype, mesh) cell captures the pair once. A block is
# the pool's leaves in order (period slot, then leaf name), flattened.
# On a mesh's pool (``tensor_parallel.ShardedCache``) the block is in the
# global layout, as the JAX package lowers it replicated: the one unit both
# slices agree on, whatever their layouts.
def page_leaves(cache: list) -> list[tuple[int, str]]:
    """The (period slot, leaf name) of every leaf of a pool, in block
    order."""
    layers = (cache.specs if isinstance(cache, tensor_parallel.ShardedCache)
              else cache)
    return [(i, n) for i, layer in enumerate(layers) for n in sorted(layer)]


def page_block(cache: list, pages: int) -> list[tuple[tuple, torch.dtype]]:
    """The (shape, dtype) of each leaf's block of ``pages`` pages, in block
    order (the global layout on a mesh's pool)."""
    out = []
    for i, n in page_leaves(cache):
        if isinstance(cache, tensor_parallel.ShardedCache):
            shape = cache.shapes[i][n]
            dt = cache.shards[cache.mesh.coords()[0]][i][n].dtype
        else:
            shape, dt = tuple(cache[i][n].shape), cache[i][n].dtype
        out.append(((shape[0], pages) + tuple(shape[2:]), dt))
    return out


def make_page_gather_fn() -> Callable:
    """``gather(params, cache, idx[B]) -> block``: B pages of every leaf (the
    migration's export half; ``params`` is unused, as every target takes
    it)."""

    def gather(params, cache, idx):
        if isinstance(cache, tensor_parallel.ShardedCache):
            return tensor_parallel.gather_mesh_pages(cache, idx,
                                                     page_leaves(cache))
        idx = idx.long()
        return tuple(cache[i][n][:, idx] for i, n in page_leaves(cache))

    return gather


def make_page_scatter_fn() -> Callable:
    """``scatter(params, cache, idx[B], *block) -> ()``: write a migrated
    block into the destination pool at ``idx``, in place (the import half;
    it returns nothing, so a captured scatter has no static output)."""

    def scatter(params, cache, idx, *block):
        if isinstance(cache, tensor_parallel.ShardedCache):
            tensor_parallel.scatter_mesh_pages(cache, idx, page_leaves(cache),
                                               block)
            return ()
        idx = idx.long()
        for (i, n), b in zip(page_leaves(cache), block):
            cache[i][n][:, idx] = b
        return ()

    return scatter


def pull_host(dev: torch.Tensor, recorder=None) -> tuple[np.ndarray, int]:
    """The d2h pull boundary: copy one device tensor to the host (blocking
    until the device has produced it) — a copy on the CPU too, so a later
    step never writes the array. Returns ``(host_array, elapsed_ns)``;
    with an enabled flight recorder a "d2h" span lands on the scheduler
    track."""
    t0 = time.perf_counter_ns()
    out = dev.to("cpu", copy=True).numpy()
    dt = time.perf_counter_ns() - t0
    if recorder is not None and recorder.enabled:
        recorder.emit(
            "d2h", "scheduler", ph="X", ts_ns=t0, dur_ns=dt,
            args={"nbytes": int(out.nbytes), "shape": list(out.shape)},
        )
    return out, dt


# ------------------------------------------------------------------ training
class TrainState(NamedTuple):
    params: dict
    opt: adamw.AdamWState


def state_shapes(cfg: ArchConfig) -> TrainState:
    """The ``TrainState``'s shapes and dtypes, on the meta device (nothing
    allocated)."""
    params = models.init_params(cfg, device="meta")
    return TrainState(params=params, opt=adamw.init(params))


def make_train_fn(
    cfg: ArchConfig,
    opt_cfg: adamw.AdamWConfig | None = None,
    *,
    impl: str = "naive",
    moe_policy: str = "drop",
    remat: bool | None = None,
    grad_compress: Callable | None = None,
) -> Callable:
    """The train step ``(state, batch) -> (new state, metrics)``: the loss
    and its gradient (``torch.autograd.grad`` over the parameter tensors,
    so no ``.grad`` field is left behind), the optional ``grad_compress``
    hook, then AdamW. ``batch`` holds tensors on the state's device;
    ``metrics`` are 0-d tensors: ``loss``, ``ce``, ``moe_aux``, ``ntok``,
    ``grad_norm``, ``lr``. The step consumes the state it is given (JAX's
    donated buffers): its tensors are updated in place and returned in the
    new state. It runs eagerly; ``impl`` must be ``"naive"`` or
    ``"chunked"`` (the kernels refuse a gradient), and ``remat`` is as
    ``models.forward``."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(state: TrainState, batch: dict):
        with torch.enable_grad():
            leaves = {k: p.detach().requires_grad_(p.is_floating_point())
                      for k, p in state.params.items()}
            loss, metrics = models.loss_fn(
                cfg, leaves, batch, impl=impl, moe_policy=moe_policy,
                remat=remat,
            )
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()), materialize_grads=True,
            )))
        if grad_compress is not None:
            grads = grad_compress(grads)
        new_p, new_opt, opt_metrics = adamw.update(
            opt_cfg, grads, state.opt, state.params
        )
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), **opt_metrics)
        return TrainState(params=new_p, opt=new_opt), metrics

    return train_step


# ------------------------------------------- steps over a mesh (full rules)
class Lowered:
    """A step built for one mesh's static shapes (the JAX package's
    ``jit(...).lower(...)``): ``compile()`` gives the step, which runs under
    the ``perf`` opts current when it was lowered; ``args`` are its
    arguments on ``meta`` (sharded pieces, and global tensors); ``arg_specs``
    parallel ``args`` with the spec of each global tensor (what each
    coordinate holds of it: ``()`` replicated) and None where the argument
    is held as pieces."""

    def __init__(self, kind: str, step: Callable, args: tuple,
                 arg_specs: tuple, mesh) -> None:
        self.kind, self.mesh = kind, mesh
        self.args, self.arg_specs = args, arg_specs
        self._step = step

    def compile(self) -> Callable:
        return self._step


def _meta(mesh) -> shd.LogicalMesh:
    """``mesh``'s coordinates over ``meta`` devices: where a lowering's
    arguments live (nothing allocated, whatever devices ``mesh`` names)."""
    return shd.LogicalMesh(tuple(mesh.shape.values()), mesh.axis_names,
                           ["meta"] * mesh.size)


def train_shardings(cfg: ArchConfig, mesh, shape: ShapeSpec):
    """(the state's shapes, the batch's shapes — ``TrainState`` and dict on
    ``meta`` —, the state's specs, the batch's specs)."""
    st = state_shapes(cfg)
    p_spec, mu_spec = fsdp.state_specs(cfg, st.params, mesh)
    state_spec = TrainState(params=p_spec, opt=adamw.AdamWState(
        step=(), mu=mu_spec, nu=mu_spec))
    batch = input_specs(cfg, "train", shape.global_batch, shape.seq_len)
    batch_spec = {k: shd.data_pspec(tuple(v.shape), mesh)
                  for k, v in batch.items()}
    return st, batch, state_spec, batch_spec


def make_mesh_train_fn(
    cfg: ArchConfig,
    mesh,
    opt_cfg: adamw.AdamWConfig | None = None,
    *,
    impl: str = "naive",
    moe_policy: str = "drop",
    donate: bool = True,
) -> Callable:
    """``make_train_fn`` over ``mesh`` with the full rules: ``step(state,
    batch) -> (new state, metrics)`` for a ``fsdp.ShardedTrainState`` and a
    global batch (split over the mesh's rows). Each coordinate gathers its
    weights at use, one ``torch.autograd.grad`` gives every coordinate's
    part of the gradient, ``fsdp.reduce_grads`` sums the parts into each
    piece's gradient and AdamW updates every piece in place. ``metrics``
    are 0-d tensors on the mesh's first device: ``loss``, ``ce``,
    ``moe_aux``, ``ntok``, ``grad_norm``, ``lr``. With ``donate`` the step
    consumes the state it is given (its pieces are updated and returned),
    else it updates a copy. A MoE stack's tail runs under ``moe_policy``
    (its aux term from the global batch, ``models.spmd.mesh_loss``). Every
    op runs once per coordinate, so a capture
    report counts 1/devices of them to a device (``capture_analysis.
    spread``), the backward too."""
    tensor_parallel.check_family(cfg)
    spmd.check_mesh(mesh)
    spmd.full_core(impl)  # refuses an attention that has no backward
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    remat = cfg.remat == "block"
    first = mesh.coords()[0]

    def train_step(state: fsdp.ShardedTrainState, batch: dict):
        p_spec = state.specs[0]
        uspecs = fsdp.use_specs(p_spec)
        with capture_analysis.spread(mesh.size):
            if not donate:
                state = fsdp.clone_state(state)
            used = fsdp.gather_params(state.params, p_spec, mesh)
        with torch.enable_grad():
            leaves = {c: {k: t.detach().requires_grad_(
                t.is_floating_point()) for k, t in ws.items()}
                for c, ws in used.items()}
            loss, metrics = spmd.mesh_loss(
                cfg, mesh, leaves, uspecs, batch, impl=impl,
                moe_policy=moe_policy, remat=remat)
            keys = [(c, k) for c in spmd.ran(mesh) for k in leaves[c]]
            with spmd.row_spread(mesh):
                got = torch.autograd.grad(
                    loss[first], [leaves[c][k] for c, k in keys],
                    materialize_grads=True)
        grads: dict = {c: {} for c in spmd.ran(mesh)}
        for (c, k), g in zip(keys, got):
            grads[c][k] = g
        del leaves, used, got
        grads = {c: grads[spmd.stand_in(mesh, c)] for c in mesh.coords()}
        with capture_analysis.spread(mesh.size):
            grads = fsdp.reduce_grads(grads, p_spec, mesh, state.specs[1])
            state, opt_metrics = fsdp.apply_adamw(opt_cfg, grads, state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss[first].detach(), **opt_metrics)
        return state, metrics

    return train_step


def lower_train(
    cfg: ArchConfig,
    mesh,
    shape: ShapeSpec,
    *,
    impl: str = "naive",
    moe_policy: str = "drop",
    donate: bool = True,
    opts: perf.PerfOpts | None = None,
    opt_cfg: adamw.AdamWConfig | None = None,
) -> Lowered:
    """The train step for ``shape`` on ``mesh`` (``make_mesh_train_fn``)
    with the optimizer ``opt_cfg`` (default ``AdamWConfig()``, as the JAX
    package's lowered step) and a MoE stack's ``moe_policy``; its batch
    holds tokens or an embeddings arch's ``[B, S, D]`` inputs
    (``models.input_specs``), and its loss reads ``perf.seq_shard_fallback``
    as ``lower_prefill``."""
    with perf.use_perf_opts(opts or perf.current()):
        fn = perf.bake(make_mesh_train_fn(cfg, mesh, opt_cfg, impl=impl,
                                          moe_policy=moe_policy,
                                          donate=donate))
    st, batch, _, batch_spec = train_shardings(cfg, mesh, shape)
    state = fsdp.shard_state(cfg, st, _meta(mesh))._replace(mesh=mesh)
    return Lowered("train", fn, (state, batch), (None, batch_spec), mesh)


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int) -> list:
    """The dense cache's leaves on ``meta`` (nothing allocated)."""
    return models.init_cache(cfg, batch, max_len, device="meta")


def _sharded_params(cfg: ArchConfig, mesh) -> tuple[dict, dict]:
    """(the params' pieces on ``meta`` by ``mesh``'s rules, their
    specs)."""
    shapes = models.init_params(cfg, device="meta")
    p_spec, _ = fsdp.state_specs(cfg, shapes, mesh)
    return {k: shd.shard(t, p_spec[k], _meta(mesh))
            for k, t in shapes.items()}, p_spec


def _copy_cache(cache: tensor_parallel.ShardedCache):
    shards = {c: [{n: t.clone() for n, t in d.items()} for d in per]
              for c, per in cache.shards.items()}
    return tensor_parallel.ShardedCache(
        cache.mesh, shards, cache.specs, cache.shapes, cache.row_block,
        seq_split=cache.seq_split)


def lower_decode(
    cfg: ArchConfig,
    mesh,
    shape: ShapeSpec,
    *,
    moe_policy: str = "drop",
    donate: bool = True,
    impl: str = "naive",  # taken for the signature; decode has one impl
    opts: perf.PerfOpts | None = None,
) -> Lowered:
    """One new token per row against a dense cache of ``shape.seq_len``:
    ``step(params, cache, inputs [B, 1] (an embeddings arch's [B, 1, D]),
    pos) -> (logits [B, V] on the mesh's first device, cache)``, params as
    pieces by the full rules
    (gathered over ``data`` at use), the cache a ``ShardedCache`` in
    ``cache_pspec_tree``'s layout, updated in place (with ``donate``; else
    a copy is)."""
    tensor_parallel.check_family(cfg)
    spmd.check_mesh(mesh)
    b, s = shape.global_batch, shape.seq_len
    params, p_spec = _sharded_params(cfg, mesh)
    uspecs = fsdp.use_specs(p_spec)
    c_shape = cache_shapes(cfg, b, s)
    c_spec = shd.cache_pspec_tree(cfg, c_shape, mesh)
    cache = tensor_parallel.ShardedCache(
        mesh, tensor_parallel._zeroed_pieces(_meta(mesh), c_shape, c_spec),
        c_spec,
        tensor_parallel._shapes(c_shape), b // spmd.num_rows(mesh),
        seq_split="model" in shd.spec_axes(c_spec[0]["k"][2]))
    ins = input_specs(cfg, "decode", b, s)

    def decode_step(params, cache, inputs, pos):
        with torch.no_grad():
            with capture_analysis.spread(mesh.size):
                if not donate:
                    cache = _copy_cache(cache)
                used = fsdp.gather_params(params, p_spec, mesh)
            logits = spmd.mesh_decode(cfg, mesh, used, uspecs, cache,
                                      inputs, pos, moe_policy=moe_policy)
        return logits, cache

    with perf.use_perf_opts(opts or perf.current()):
        fn = perf.bake(decode_step)
    return Lowered("decode", fn, (params, cache, ins["inputs"], ins["pos"]),
                   (None, None, shd.data_pspec(tuple(ins["inputs"].shape),
                                               mesh), ()), mesh)


def lower_prefill(
    cfg: ArchConfig,
    mesh,
    shape: ShapeSpec,
    *,
    impl: str = "naive",
    moe_policy: str = "drop",
    opts: perf.PerfOpts | None = None,
) -> Lowered:
    """``step(params, inputs [B, S] (an embeddings arch's [B, S, D])) ->
    (the last token's logits [B, V] on the mesh's first device, the dense
    cache as a ``ShardedCache`` in ``cache_pspec_tree``'s layout)``, params
    as ``lower_decode``'s. Under ``perf.seq_shard_fallback`` (``opts``, or
    the opts current at lowering) attention splits its query sequence over
    ``model`` where the heads do not divide (``models.spmd``)."""
    tensor_parallel.check_family(cfg)
    spmd.check_mesh(mesh)
    b, s = shape.global_batch, shape.seq_len
    params, p_spec = _sharded_params(cfg, mesh)
    uspecs = fsdp.use_specs(p_spec)
    c_spec = shd.cache_pspec_tree(cfg, cache_shapes(cfg, b, s), mesh)
    ins = input_specs(cfg, "prefill", b, s)

    def prefill_step(params, inputs):
        with torch.no_grad():
            with capture_analysis.spread(mesh.size):
                used = fsdp.gather_params(params, p_spec, mesh)
            return spmd.mesh_prefill(cfg, mesh, used, uspecs, inputs,
                                     c_spec, impl=impl,
                                     moe_policy=moe_policy)

    with perf.use_perf_opts(opts or perf.current()):
        fn = perf.bake(prefill_step)
    return Lowered("prefill", fn, (params, ins["inputs"]),
                   (None, shd.data_pspec(tuple(ins["inputs"].shape), mesh)),
                   mesh)


def lower_for(cfg: ArchConfig, mesh, shape: ShapeSpec, **kw) -> Lowered:
    if shape.kind == "train":
        return lower_train(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return lower_prefill(cfg, mesh, shape, **kw)
    if shape.kind == "decode":
        return lower_decode(cfg, mesh, shape, **kw)
    raise ValueError(shape.kind)


def place_train_state(cfg: ArchConfig, state, mesh) -> fsdp.ShardedTrainState:
    """Elastic re-mesh: place a ``TrainState`` (one device's, or a restored
    checkpoint's: checkpoints hold the joined arrays) or a state sharded on
    another mesh onto ``mesh`` by the rules; every piece a copy on its
    coordinate's device."""
    if isinstance(state, fsdp.ShardedTrainState):
        state = fsdp.unshard_state(state)
    return fsdp.shard_state(cfg, state, mesh)
