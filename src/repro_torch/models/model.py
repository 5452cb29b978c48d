"""Top-level LM for the paged serving path (counterpart of ``repro.models.model``).

Params are a flat ``dict[str, Tensor]`` keyed by the JAX pytree's paths::

    "embed.embedding"            [V, D]
    "head.lm_head"               [D, V]      (untied heads only)
    "final_norm.scale"           [D]         (rmsnorm only)
    "blocks.{slot}.attn.wq"      [m, D, H, dh]   ... stacked [m, ...] per
    "blocks.{slot}.mlp.w_gate"   [m, D, F]       period slot, as in JAX

Caches mirror the blocks: one ``{"k", "v"}`` dict of ``[m, P, page_size, KH,
dh]`` pages per period slot. The JAX package drives depth with
``lax.scan``; here it is a Python loop over layers, and each layer's cache
is a view into the stacked tensor, updated in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig

from .attention import init_paged_kv_cache
from .blocks import block_paged_decode, block_paged_prefill
from .layers import dtype_of, embed_apply, head_apply, norm_apply


def init_params(
    cfg: ArchConfig, seed: int = 0, device: torch.device | str = "cpu"
) -> dict[str, torch.Tensor]:
    """Seeded random weights in the JAX package's layout and scales
    (``dense_init``: normal / sqrt(fan_in) with fan_in the per-layer shape's
    first axis; embeddings normal * 0.02; norm weights zero). Drawn from a
    ``torch.Generator`` on ``device``, so the values differ from JAX's."""
    if cfg.input_kind != "tokens":
        raise ValueError(f"{cfg.name}: embedding-input frontends are not ported")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = dtype_of(cfg)
    m = cfg.num_layers // cfg.period
    d, h, kh, dh, f = (
        cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    )

    def normal(shape: tuple, std: float) -> torch.Tensor:
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (x * std).to(dt)

    def dense(*shape: int) -> torch.Tensor:  # stacked [m, *shape]
        return normal((m, *shape), shape[0] ** -0.5)

    def zeros(*shape: int) -> torch.Tensor:
        return torch.zeros(shape, dtype=dt, device=device)

    rms = cfg.norm == "rmsnorm"
    params = {"embed.embedding": normal((cfg.vocab_size, d), 0.02)}
    if not cfg.tie_embeddings:
        params["head.lm_head"] = normal((d, cfg.vocab_size), 0.02)
    if rms:
        params["final_norm.scale"] = zeros(d)
    for slot in range(cfg.period):
        if not cfg.mixer_at(slot).startswith("attn") or cfg.mlp_at(slot) not in (
            "mlp", "none"
        ):
            raise ValueError(
                f"{cfg.name}: slot {slot} ({cfg.mixer_at(slot)}, "
                f"{cfg.mlp_at(slot)}) is not ported"
            )
        pre = f"blocks.{slot}."
        if rms:
            params[pre + "norm1.scale"] = zeros(m, d)
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


def init_paged_cache(
    cfg: ArchConfig,
    num_pages: int,
    page_size: int,
    device: torch.device | str = "cpu",
) -> list:
    """Pooled paged KV cache, stacked ``[m, ...]`` per period slot. ``num_pages``
    includes the reserved null page 0."""
    m = cfg.num_layers // cfg.period
    out = []
    for _ in range(cfg.period):
        one = init_paged_kv_cache(cfg, num_pages, page_size, device)
        out.append({k: t[None].repeat(m, *([1] * t.dim())) for k, t in one.items()})
    return out


def _layers(cfg: ArchConfig, params: dict, cache: list):
    """(slot, layer params, layer cache view) in depth order."""
    for i in range(cfg.num_layers // cfg.period):
        for slot in range(cfg.period):
            c = {k: t[i] for k, t in cache[slot].items()}
            yield slot, layer_params(params, slot, i), c


def _final_norm(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    return norm_apply(cfg, params.get("final_norm.scale"), x)


def paged_decode_step(
    cfg: ArchConfig,
    params: dict,
    cache: list,
    inputs: torch.Tensor,
    pos: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    attn_impl: str = "kernel",
) -> tuple[torch.Tensor, list]:
    """One token for the whole stack through the paged KV cache.

    inputs: i32[B,1] tokens; pos: i32[B]; block_tables: i32[B, pages_bucket].
    Returns (logits [B,V] float32, cache updated in place).
    """
    x = embed_apply(cfg, params["embed.embedding"], inputs)
    for slot, p, c in _layers(cfg, params, cache):
        x, _ = block_paged_decode(
            cfg, slot, p, x, c, pos, block_tables, attn_impl=attn_impl
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
) -> tuple[torch.Tensor, list]:
    """A chunk of C prompt tokens for the whole stack (DESIGN.md §10).

    inputs: i32[B,C] (columns >= ``length`` are bucket padding); start:
    i32[B]; block_tables: i32[B, PB]; length: i32[B]. Returns (logits of the
    last real chunk row [B,V] float32, cache updated in place).
    """
    x = embed_apply(cfg, params["embed.embedding"], inputs)
    for slot, p, c in _layers(cfg, params, cache):
        x, _ = block_paged_prefill(
            cfg, slot, p, x, c, start, block_tables, length,
            attn_impl=attn_impl,
        )
    x = _final_norm(cfg, params, x)
    return head_apply(cfg, params, _last_real_row(x, length)), cache


def copy_cache_pages(cache: list, src: int, dst: int) -> list:
    """Copy one physical page's contents in every layer — the device half
    of copy-on-write (``kvcache.BlockTable.ensure_writable``). In place:
    ``dst`` pages are overwritten, nothing is reallocated."""
    for slot_cache in cache:
        for t in slot_cache.values():
            t[:, dst] = t[:, src]
    return cache
