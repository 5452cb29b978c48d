"""Top-level LM: full-sequence forward and prefill, the paged serving path,
dense-cache decode (burst engine, dense continuous engine and speculative
draft), and the training loss: counterpart of ``repro.models.model``.

Params are a flat ``dict[str, Tensor]`` keyed by the JAX pytree's paths::

    "embed.embedding"            [V, D]      (token inputs only)
    "head.lm_head"               [D, V]      (untied or embeddings heads)
    "final_norm.scale"           [D]         (rmsnorm only)
    "blocks.{slot}.attn.wq"      [m, D, H, dh]   ... stacked [m, ...] per
    "blocks.{slot}.mlp.w_gate"   [m, D, F]       period slot, as in JAX
    "blocks.{slot}.moe.router"   [m, D, E]       (float32 in any model dtype)
    "blocks.{slot}.moe.w_gate"   [m, E, D, F]

Caches mirror the blocks: per period slot, one dict of ``[m, P, page_size,
KH, dh]`` pages (plus ``[m, P, page_size]`` scales for int8 pages), or, for
the dense cache, ``[m, B, max_len, KH, dh]`` rows (``prefill`` returns it at
the prompt's length; ``pad_cache`` grows it) — for a mamba slot the
recurrent ``{"conv": [m, B, K-1, C], "state": [m, B, H, P, N] float32}``,
whose size does not depend on the length. The JAX package
drives depth with ``lax.scan``; here it is a Python loop over layers, and
each layer's cache is a view into the stacked tensor, updated in place.
"""

from __future__ import annotations

import contextlib
from dataclasses import replace

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as checkpoint_utils

from repro_torch import perf
from repro_torch.configs import ArchConfig

from . import tensor_parallel
from .attention import init_paged_kv_cache
from .blocks import (
    block_apply,
    block_cache_init,
    block_chunk_decode,
    block_decode,
    block_paged_decode,
    block_paged_prefill,
    block_prefill,
    check_paged_slot,
)
from .layers import dtype_of, embed_apply, head_apply, norm_apply

MOE_AUX_WEIGHT = 0.01  # the load-balancing term's weight in the loss


_DRAW_ELEMS = 1 << 28  # f32 values drawn at once by init_params (1 GiB)


def init_params(
    cfg: ArchConfig, seed: int = 0, device: torch.device | str = "cpu"
) -> dict[str, torch.Tensor]:
    """Seeded random weights in the JAX package's layout and scales
    (``dense_init``: normal / sqrt(fan_in) with fan_in the per-layer shape's
    first axis; embeddings normal * 0.02; norm weights zero; a mamba
    slot's conv normal * 0.1, ``A_log``/``dt_bias`` float32 zeros and ``D``
    float32 ones, as ``ssm_init``; a MoE slot's router float32 with std
    1/sqrt(D) and its experts ``[E, D, F]`` / ``[E, F, D]`` std 1/sqrt(E),
    as ``moe_init``). Drawn from a ``torch.Generator`` on
    ``device``, so the values differ from JAX's: in f32 slabs of at most
    ``_DRAW_ELEMS`` along the first axis (a layer of a stacked tensor at a
    time), each scaled and cast into the model-dtype tensor, so the peak
    is the weights plus one slab (gemma2-27b's stacked MLP weight would
    otherwise be a 15.6 GB f32 temporary on top of 54 GB of bf16)."""
    gen = None  # the meta device draws nothing (shapes only)
    if torch.device(device).type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    dt = dtype_of(cfg)
    m = cfg.num_layers // cfg.period
    d, h, kh, dh, f = (
        cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    )

    def normal(shape: tuple, std: float, dtype: torch.dtype = dt
               ) -> torch.Tensor:
        out = torch.empty(shape, dtype=dtype, device=device)
        rows = out.view(shape[0], -1)
        step = max(1, _DRAW_ELEMS // max(rows.shape[1], 1))
        for i in range(0, shape[0], step):
            part = rows[i:i + step]
            part.copy_(torch.randn(part.shape, generator=gen, device=device,
                                   dtype=torch.float32).mul_(std))
        return out

    def dense(*shape: int, dtype: torch.dtype = dt) -> torch.Tensor:
        return normal((m, *shape), shape[0] ** -0.5, dtype)  # stacked [m, ...]

    def zeros(*shape: int, dtype: torch.dtype = dt) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=device)

    rms = cfg.norm == "rmsnorm"
    tokens = cfg.input_kind == "tokens"
    params = {}
    if tokens:  # an embeddings arch's stub frontend has no table
        params["embed.embedding"] = normal((cfg.vocab_size, d), 0.02)
    if not (cfg.tie_embeddings and tokens):
        params["head.lm_head"] = normal((d, cfg.vocab_size), 0.02)
    if rms:
        params["final_norm.scale"] = zeros(d)
    for slot in range(cfg.period):
        pre = f"blocks.{slot}."
        if rms:
            params[pre + "norm1.scale"] = zeros(m, d)
        if cfg.mixer_at(slot) == "mamba":
            din, nh = cfg.ssm_d_inner, cfg.ssm_heads
            gn = cfg.ssm_groups * cfg.ssm_state
            params[pre + "ssm.wz"] = dense(d, din)
            params[pre + "ssm.wx"] = dense(d, din)
            params[pre + "ssm.wB"] = dense(d, gn)
            params[pre + "ssm.wC"] = dense(d, gn)
            params[pre + "ssm.wdt"] = dense(d, nh)
            params[pre + "ssm.conv"] = normal(
                (m, cfg.conv_kernel, din + 2 * gn), 0.1)
            params[pre + "ssm.A_log"] = zeros(m, nh, dtype=torch.float32)
            params[pre + "ssm.D"] = torch.ones(
                (m, nh), dtype=torch.float32, device=device)
            params[pre + "ssm.dt_bias"] = zeros(m, nh, dtype=torch.float32)
            params[pre + "ssm.norm_scale"] = zeros(m, din)
            params[pre + "ssm.out"] = dense(din, d)
        else:
            params[pre + "attn.wq"] = dense(d, h, dh)
            params[pre + "attn.wk"] = dense(d, kh, dh)
            params[pre + "attn.wv"] = dense(d, kh, dh)
            params[pre + "attn.wo"] = dense(h, dh, d)
            if cfg.qk_norm:
                params[pre + "attn.q_scale"] = zeros(m, dh)
                params[pre + "attn.k_scale"] = zeros(m, dh)
        if cfg.mlp_at(slot) == "mlp":
            if rms:
                params[pre + "norm2.scale"] = zeros(m, d)
            params[pre + "mlp.w_gate"] = dense(d, f)
            params[pre + "mlp.w_up"] = dense(d, f)
            params[pre + "mlp.w_down"] = dense(f, d)
        elif cfg.mlp_at(slot) == "moe":
            e, ef = cfg.num_experts, cfg.expert_d_ff or cfg.d_ff
            if rms:
                params[pre + "norm2.scale"] = zeros(m, d)
            params[pre + "moe.router"] = dense(d, e, dtype=torch.float32)
            params[pre + "moe.w_gate"] = dense(e, d, ef)
            params[pre + "moe.w_up"] = dense(e, d, ef)
            params[pre + "moe.w_down"] = dense(e, ef, d)
    return params


def layer_params(params: dict, slot: int, i: int) -> dict:
    """Layer ``i`` of period slot ``slot`` as the nested dict the blocks
    take (``{"attn": {"wq": ...}, "mlp": {...}, "norm1": {...}}``); leaves
    are views of the stacked tensors."""
    prefix = f"blocks.{slot}."
    out: dict = {}
    for name, t in params.items():
        if name.startswith(prefix):
            module, leaf = name[len(prefix):].split(".", 1)
            out.setdefault(module, {})[leaf] = t[i]
    return out


def _stack(one: dict, m: int) -> dict:
    return {k: t[None].repeat(m, *([1] * t.dim())) for k, t in one.items()}


def init_paged_cache(
    cfg: ArchConfig,
    num_pages: int,
    page_size: int,
    kv_dtype: str = "fp32",
    device: torch.device | str = "cpu",
) -> list:
    """Pooled paged KV cache, stacked ``[m, ...]`` per period slot. ``num_pages``
    includes the reserved null page 0. ``kv_dtype="int8"`` adds the
    ``k_scale``/``v_scale`` leaves ``[m, P, page_size]``, which share the page
    axis, so ``copy_cache_pages`` moves them with the pages. Attention-only
    stacks (SSM state is per row, not pageable)."""
    check_paged(cfg)
    m = cfg.num_layers // cfg.period
    return [
        _stack(init_paged_kv_cache(cfg, num_pages, page_size, kv_dtype, device), m)
        for _ in range(cfg.period)
    ]


def check_paged(cfg: ArchConfig) -> None:
    """Raise unless every period slot can live in the paged KV cache."""
    for slot in range(cfg.period):
        check_paged_slot(cfg, slot)


def init_cache(
    cfg: ArchConfig,
    batch: int,
    max_len: int,
    kv_dtype: str = "fp32",
    device: torch.device | str = "cpu",
) -> list:
    """Dense per-slot cache (the burst engine's, the dense continuous
    engine's and the draft lanes' storage), stacked ``[m, ...]`` per period
    slot; ``kv_dtype="int8"`` adds ``ks``/``vs`` scale leaves (attention
    slots only); a mamba slot holds its conv window and state whatever
    ``max_len``."""
    m = cfg.num_layers // cfg.period
    return [
        _stack(block_cache_init(cfg, slot, batch, max_len, kv_dtype, device), m)
        for slot in range(cfg.period)
    ]


def _layers(cfg: ArchConfig, params: dict, cache: list):
    """(slot, layer params, layer cache view) in depth order."""
    for i in range(cfg.num_layers // cfg.period):
        for slot in range(cfg.period):
            c = {k: t[i] for k, t in cache[slot].items()}
            yield slot, layer_params(params, slot, i), c


def _final_norm(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    return norm_apply(cfg, params.get("final_norm.scale"), x)


def _positions(x: torch.Tensor) -> torch.Tensor:
    """Positions 0..S-1 of every row of x [B,S,...] as i32[B,S]."""
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def _remat_context():
    """``perf``'s ``remat_policy`` as a checkpoint context: "dots" keeps the
    matrix products' outputs (``jax.checkpoint_policies.checkpoint_dots``)
    and recomputes the rest; "full" recomputes everything."""
    if perf.current().remat_policy != "dots":
        return contextlib.nullcontext(), contextlib.nullcontext()
    return checkpoint_utils.create_selective_checkpoint_contexts(
        _save_dots
    )


_DOTS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
})


def _save_dots(ctx, op, *args, **kwargs):
    return (checkpoint_utils.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else checkpoint_utils.CheckpointPolicy.PREFER_RECOMPUTE)


def forward(
    cfg: ArchConfig,
    params: dict,
    inputs: torch.Tensor,
    *,
    impl: str = "kernel",
    moe_policy: str = "drop",
    remat: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """inputs: i32[B,S] tokens, or [B,S,D] stub-frontend embeddings for an
    ``input_kind="embeddings"`` arch (as every entry point below). Returns
    (logits [B,S,V] float32, aux): the JAX package's pair; ``aux`` is the
    MoE load-balancing term summed over the MoE layers (0 without them),
    under ``moe_policy`` (``models.moe``). ``impl`` picks the
    attention — ``"kernel"`` (B6), ``"naive"``, ``"chunked"`` or
    ``"auto"`` (``perf.current().impl``) — and the SSD scan of mamba
    slots: ``"kernel"`` (B8), else ``ssd_scan``. The kernels have no
    backward and refuse inputs that need a gradient, so training takes
    ``"naive"`` or ``"chunked"`` (``loss_fn``'s default).

    ``remat`` (None: ``cfg.remat == "block"``) recomputes each period of
    blocks in the backward pass (``torch.utils.checkpoint`` around the
    period, as the JAX package's ``jax.checkpoint`` around its scan body),
    under ``perf``'s ``remat_policy``. It changes no value, only what the
    backward keeps."""
    if remat is None:
        remat = cfg.remat == "block"
    # only a backward needs the recomputation: serving never pays for it
    remat = remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in params.values())
    x = embed_apply(cfg, params, inputs)
    positions = _positions(x)

    def period(x: torch.Tensor, aux: torch.Tensor,
               i: int) -> tuple[torch.Tensor, torch.Tensor]:
        for slot in range(cfg.period):
            x, a = block_apply(
                cfg, slot, layer_params(params, slot, i), x, positions,
                impl=impl, moe_policy=moe_policy,
            )
            if a is not None:
                aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers // cfg.period):
        if remat:
            x, aux = checkpoint_utils.checkpoint(
                period, x, aux, i, use_reentrant=False,
                context_fn=_remat_context,
            )
        else:
            x, aux = period(x, aux, i)
    x = _final_norm(cfg, params, x)
    return head_apply(cfg, params, x), aux


def loss_fn(
    cfg: ArchConfig,
    params: dict,
    batch: dict,
    *,
    impl: str = "naive",
    moe_policy: str = "drop",
    remat: bool | None = None,
) -> tuple[torch.Tensor, dict]:
    """batch: {"inputs": tokens | embeddings, "labels": i32[B,S] (-1 =
    pad)}. Returns (cross-entropy over the valid labels + ``MOE_AUX_WEIGHT``
    x aux, {"ce", "moe_aux", "ntok"}), as the JAX package's ``loss_fn``;
    ``remat`` as ``forward``."""
    logits, aux = forward(cfg, params, batch["inputs"], impl=impl,
                          moe_policy=moe_policy, remat=remat)
    labels = batch["labels"]
    valid = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = (logz - ll) * valid
    ntok = torch.clamp(torch.sum(valid), min=1.0)
    loss = torch.sum(ce) / ntok
    total = loss + MOE_AUX_WEIGHT * aux
    return total, {"ce": loss, "moe_aux": aux, "ntok": ntok}


def input_specs(cfg: ArchConfig, kind: str, batch: int, seq: int,
                device: torch.device | str = "meta") -> dict:
    """Stand-ins for every input of a ``kind`` step (``"train"``,
    ``"prefill"``, ``"decode"``) on ``device`` (``meta``: nothing
    allocated): tokens i32, or a stub frontend's embeddings in the model
    dtype for an ``input_kind="embeddings"`` arch, as the JAX package's
    ``input_specs``."""
    def empty(*shape: int, dtype=torch.int32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=device)

    emb = cfg.input_kind != "tokens"
    width = (cfg.d_model,) if emb else ()
    dt = dtype_of(cfg) if emb else torch.int32
    if kind == "train":
        return {"inputs": empty(batch, seq, *width, dtype=dt),
                "labels": empty(batch, seq)}
    if kind == "prefill":
        return {"inputs": empty(batch, seq, *width, dtype=dt)}
    if kind == "decode":
        return {"inputs": empty(batch, 1, *width, dtype=dt), "pos": empty()}
    raise ValueError(kind)


def prefill(
    cfg: ArchConfig,
    params: dict,
    inputs: torch.Tensor,
    *,
    impl: str = "kernel",
    moe_policy: str = "drop",
) -> tuple[torch.Tensor, list]:
    """Run the full prompt i32[B,S] (or embeddings [B,S,D]); returns
    (last-token logits [B,V] float32, dense cache stacked ``[m, B, S, KH,
    dh]`` per period slot, or ``{conv, state}`` stacked ``[m, ...]`` for a
    mamba slot); ``impl`` and ``moe_policy`` as ``forward``."""
    x = embed_apply(cfg, params, inputs)
    positions = _positions(x)
    per_slot: list[list[dict]] = [[] for _ in range(cfg.period)]
    for i in range(cfg.num_layers // cfg.period):
        for slot in range(cfg.period):
            x, c = block_prefill(
                cfg, slot, layer_params(params, slot, i), x, positions,
                impl=impl, moe_policy=moe_policy,
            )
            per_slot[slot].append(c)
    x = _final_norm(cfg, params, x)
    cache = [
        {name: torch.stack([c[name] for c in layers]) for name in layers[0]}
        for layers in per_slot
    ]
    return head_apply(cfg, params, x[:, -1]), cache


def pad_cache(cfg: ArchConfig, cache: list, max_len: int) -> list:
    """Grow a prefill cache (length = prompt) to ``max_len`` rows for
    decoding: ``[m, B, S, KH, dh]`` -> ``[m, B, max_len, KH, dh]``, zeros
    past the prompt. A mamba slot's cache has no length axis and is
    returned as it is."""
    return [
        slot_cache if cfg.mixer_at(slot) == "mamba" else {
            name: F.pad(t, (0, 0, 0, 0, 0, max_len - t.shape[2]))
            for name, t in slot_cache.items()
        }
        for slot, slot_cache in enumerate(cache)
    ]


def paged_decode_step(
    cfg: ArchConfig,
    params: dict,
    cache: list,
    inputs: torch.Tensor,
    pos: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    attn_impl: str = "kernel",
    moe_policy: str = "drop",
) -> tuple[torch.Tensor, list]:
    """One token for the whole stack through the paged KV cache.

    inputs: i32[B,1] tokens; pos: i32[B]; block_tables: i32[B, pages_bucket].
    Returns (logits [B,V] float32, cache updated in place).
    """
    x = embed_apply(cfg, params, inputs)
    for slot, p, c in _layers(cfg, params, cache):
        x, _ = block_paged_decode(
            cfg, slot, p, x, c, pos, block_tables, attn_impl=attn_impl,
            moe_policy=moe_policy,
        )
    x = _final_norm(cfg, params, x)
    return head_apply(cfg, params, x[:, -1]), cache


def _last_real_row(x: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """x: [B,C,D]; row ``length - 1`` of each batch element -> [B,D] (the
    chunk's last real token; bucket-padding rows carry garbage)."""
    last = (length.long() - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), last]


def paged_prefill_step(
    cfg: ArchConfig,
    params: dict,
    cache: list,
    inputs: torch.Tensor,
    start: torch.Tensor,
    block_tables: torch.Tensor,
    length: torch.Tensor,
    *,
    attn_impl: str = "kernel",
    moe_policy: str = "drop",
) -> tuple[torch.Tensor, list]:
    """A chunk of C prompt tokens for the whole stack (DESIGN.md §10).

    inputs: i32[B,C] (columns >= ``length`` are bucket padding); start:
    i32[B]; block_tables: i32[B, PB]; length: i32[B]. Returns (logits of the
    last real chunk row [B,V] float32, cache updated in place).
    """
    x = _paged_chunk_hidden(
        cfg, params, cache, inputs, start, block_tables, length, attn_impl,
        moe_policy,
    )
    return head_apply(cfg, params, _last_real_row(x, length)), cache


def _paged_chunk_hidden(
    cfg: ArchConfig,
    params: dict,
    cache: list,
    inputs: torch.Tensor,
    start: torch.Tensor,
    block_tables: torch.Tensor,
    length: torch.Tensor,
    attn_impl: str,
    moe_policy: str,
) -> torch.Tensor:
    """The chunk tower shared by the paged prompt and verify paths: embed,
    every layer through ``block_paged_prefill``, final norm -> [B,C,D]."""
    x = embed_apply(cfg, params, inputs)
    for slot, p, c in _layers(cfg, params, cache):
        x, _ = block_paged_prefill(
            cfg, slot, p, x, c, start, block_tables, length,
            attn_impl=attn_impl, moe_policy=moe_policy,
        )
    return _final_norm(cfg, params, x)


def paged_verify_step(
    cfg: ArchConfig,
    params: dict,
    cache: list,
    inputs: torch.Tensor,
    start: torch.Tensor,
    block_tables: torch.Tensor,
    length: torch.Tensor,
    *,
    attn_impl: str = "kernel",
    moe_policy: str = "drop",
) -> tuple[torch.Tensor, list]:
    """Verify lane (DESIGN.md §11): score all K+1 positions of a draft window
    in one pass through the paged chunk tower. Same contract as
    ``paged_prefill_step`` (inputs are the current token followed by K draft
    candidates; columns >= ``length`` write only the null page), but the head
    projects every row: returns (logits [B,C,V] float32, cache updated in
    place). Row i's logits are what ``paged_decode_step`` gives after feeding
    rows 0..i one at a time, up to the order of float sums."""
    x = _paged_chunk_hidden(
        cfg, params, cache, inputs, start, block_tables, length, attn_impl,
        moe_policy,
    )
    return head_apply(cfg, params, x), cache


def decode_step(
    cfg: ArchConfig,
    params: dict,
    cache: list,
    inputs: torch.Tensor,
    pos: torch.Tensor,
    *,
    attn_impl: str = "kernel",
    moe_policy: str = "drop",
) -> tuple[torch.Tensor, list]:
    """One token for the whole stack through the dense per-slot cache.

    inputs: i32[B,1] (or embeddings [B,1,D]); pos: a 0-dim i32 tensor (the
    whole batch at one position — the burst engine; attention B5 or plain;
    an int8 cache raises) or i32[B] per-row positions (the ``cb`` and
    ``dr`` lanes; attention B1/B3 over the cache's page view, or plain). ``attn_impl``
    picks "kernel" or "plain" either way. Mamba slots ignore ``pos``.
    Returns (logits [B,V] float32, cache updated in place)."""
    x = embed_apply(cfg, params, inputs)
    for slot, p, c in _layers(cfg, params, cache):
        x, _ = block_decode(cfg, slot, p, x, c, pos, attn_impl=attn_impl,
                            moe_policy=moe_policy)
    x = _final_norm(cfg, params, x)
    return head_apply(cfg, params, x[:, -1]), cache


def _dense_chunk_hidden(
    cfg: ArchConfig,
    params: dict,
    cache: list,
    inputs: torch.Tensor,
    start: torch.Tensor,
    length: torch.Tensor,
    attn_impl: str,
    moe_policy: str,
) -> torch.Tensor:
    """The chunk tower over the dense per-slot cache -> normed [B,C,D]."""
    x = embed_apply(cfg, params, inputs)
    for slot, p, c in _layers(cfg, params, cache):
        x, _ = block_chunk_decode(cfg, slot, p, x, c, start, length,
                                  attn_impl=attn_impl, moe_policy=moe_policy)
    return _final_norm(cfg, params, x)


def chunked_decode_step(
    cfg: ArchConfig,
    params: dict,
    cache: list,
    inputs: torch.Tensor,
    start: torch.Tensor,
    length: torch.Tensor,
    *,
    attn_impl: str = "kernel",
    moe_policy: str = "drop",
) -> tuple[torch.Tensor, list]:
    """A chunk of C tokens for the whole stack into the dense per-slot cache
    (the ``pfd`` lane and the draft's prompt mirror ``drp``). inputs:
    i32[B,C]; start, length: i32[B] (length 0 = idle row); attention B2/B4
    over the cache's page view with ``attn_impl="kernel"``. Returns (logits
    of the last real chunk row [B,V] float32, cache updated in place)."""
    x = _dense_chunk_hidden(cfg, params, cache, inputs, start, length,
                            attn_impl, moe_policy)
    return head_apply(cfg, params, _last_real_row(x, length)), cache


def chunked_verify_step(
    cfg: ArchConfig,
    params: dict,
    cache: list,
    inputs: torch.Tensor,
    start: torch.Tensor,
    length: torch.Tensor,
    *,
    attn_impl: str = "kernel",
    moe_policy: str = "drop",
) -> tuple[torch.Tensor, list]:
    """Verify lane over the dense per-slot cache (DESIGN.md §11), the
    ``vfd`` lane: score all K+1 positions of a draft window in one pass —
    ``chunked_decode_step`` with the head over every chunk row. Returns
    (logits [B,C,V] float32, cache updated in place); rows with length 0
    are idle and write nothing."""
    x = _dense_chunk_hidden(cfg, params, cache, inputs, start, length,
                            attn_impl, moe_policy)
    return head_apply(cfg, params, x), cache


def draft_view(
    cfg: ArchConfig, params: dict, draft_layers: int = 1
) -> tuple[ArchConfig, dict]:
    """Truncated-layer draft model: the speculative-decode predictor as a
    view of the target (DESIGN.md §11), no extra weights.

    Keeps the first ``draft_layers`` repetitions of every period slot —
    each ``blocks.*`` tensor's leading ``[m]`` axis is sliced (a view, no
    copy) — and shares the embedding, head and final norm tensors with the
    target. Returns ``(draft_cfg, draft_params)``."""
    m = cfg.num_layers // cfg.period
    d = max(1, min(int(draft_layers), m))
    dcfg = replace(
        cfg, name=f"{cfg.name}-draft{d}", num_layers=d * cfg.period
    ).validate()
    dparams = {
        k: (t[:d] if k.startswith("blocks.") else t) for k, t in params.items()
    }
    return dcfg, dparams


def copy_cache_pages(cache: list, src: int, dst: int) -> list:
    """Copy one physical page's contents in every layer — the device half
    of copy-on-write (``kvcache.BlockTable.ensure_writable``). Every leaf
    with a page axis moves, int8 pages' scales included. In place: ``dst``
    pages are overwritten, nothing is reallocated. A mesh's pool
    (``tensor_parallel.ShardedCache``) copies within the pages' data row."""
    if isinstance(cache, tensor_parallel.ShardedCache):
        tensor_parallel.copy_mesh_pages(cache, src, dst)
        return cache
    for slot_cache in cache:
        for t in slot_cache.values():
            t[:, dst] = t[:, src]
    return cache
