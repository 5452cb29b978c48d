"""Attention + MLP blocks: full sequence, through the paged KV cache, and
through the dense cache (counterpart of ``repro.models.blocks``)."""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig

from . import attention as attn
from . import mlp as mlp_mod
from .layers import norm_apply


def _mixer(cfg: ArchConfig, slot: int, what: str) -> bool:
    """Attention-only stacks; returns whether the slot's mixer is local."""
    mixer = cfg.mixer_at(slot)
    if not mixer.startswith("attn"):
        raise ValueError(
            f"{cfg.name}: slot {slot} mixer {mixer!r}: {what} is "
            f"attention-only."
        )
    return mixer == "attn_local"


def _scale(p: dict, norm: str) -> torch.Tensor | None:
    """The norm's weight, None for the non-parametric LayerNorm."""
    return p.get(norm, {}).get("scale")


def _block_tail(
    cfg: ArchConfig, slot: int, p: dict, x: torch.Tensor
) -> torch.Tensor:
    """Residual MLP tail (MoE slots are ported with granite-moe)."""
    mlp = cfg.mlp_at(slot)
    if mlp == "none":
        return x
    if mlp != "mlp":
        raise ValueError(f"{cfg.name}: slot {slot} mlp {mlp!r} is not ported")
    h = norm_apply(cfg, _scale(p, "norm2"), x)
    return x + mlp_mod.mlp_apply(cfg, p["mlp"], h)


def block_apply(
    cfg: ArchConfig,
    slot: int,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    impl: str = "kernel",
) -> torch.Tensor:
    """Full-sequence block (``forward``)."""
    local = _mixer(cfg, slot, "the full-sequence path")
    h = norm_apply(cfg, _scale(p, "norm1"), x)
    h = attn.attention(cfg, p["attn"], h, positions, local=local, impl=impl)
    return _block_tail(cfg, slot, p, x + h)


def block_prefill(
    cfg: ArchConfig,
    slot: int,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    impl: str = "kernel",
) -> tuple[torch.Tensor, dict]:
    """Full-sequence block that also emits this slot's cache entry."""
    local = _mixer(cfg, slot, "prefill")
    h = norm_apply(cfg, _scale(p, "norm1"), x)
    h, cache = attn.prefill_attention(
        cfg, p["attn"], h, positions, local=local, impl=impl
    )
    return _block_tail(cfg, slot, p, x + h), cache


def block_paged_decode(
    cfg: ArchConfig,
    slot: int,
    p: dict,
    x: torch.Tensor,
    cache: dict,
    pos: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    attn_impl: str = "kernel",
) -> tuple[torch.Tensor, dict]:
    """Single-token block step through the paged KV cache (DESIGN.md §9)."""
    local = _mixer(cfg, slot, "paged decode")
    h = norm_apply(cfg, _scale(p, "norm1"), x)
    h, cache = attn.paged_decode_attention(
        cfg, p["attn"], h, cache, pos, block_tables,
        local=local, attn_impl=attn_impl,
    )
    return _block_tail(cfg, slot, p, x + h), cache


def block_paged_prefill(
    cfg: ArchConfig,
    slot: int,
    p: dict,
    x: torch.Tensor,
    cache: dict,
    start: torch.Tensor,
    block_tables: torch.Tensor,
    length: torch.Tensor,
    *,
    attn_impl: str = "kernel",
) -> tuple[torch.Tensor, dict]:
    """Chunked-prefill block step through the paged KV cache (DESIGN.md §10)."""
    local = _mixer(cfg, slot, "paged prefill")
    h = norm_apply(cfg, _scale(p, "norm1"), x)
    h, cache = attn.paged_prefill_attention(
        cfg, p["attn"], h, cache, start, block_tables, length,
        local=local, attn_impl=attn_impl,
    )
    return _block_tail(cfg, slot, p, x + h), cache


# ------------------------------------------------- the draft's dense cache
def block_cache_init(
    cfg: ArchConfig,
    slot: int,
    batch: int,
    max_len: int,
    kv_dtype: str = "fp32",
    device: torch.device | str = "cpu",
) -> dict:
    """One slot's dense per-slot KV cache (attention-only stacks)."""
    _mixer(cfg, slot, "the dense cache")
    return attn.init_kv_cache(cfg, batch, max_len, kv_dtype, device)


def block_decode(
    cfg: ArchConfig,
    slot: int,
    p: dict,
    x: torch.Tensor,
    cache: dict,
    pos: torch.Tensor,
    *,
    attn_impl: str = "kernel",
) -> tuple[torch.Tensor, dict]:
    """Single-token block step into the dense cache at a scalar position
    (the burst engine) or per-row positions (the draft)."""
    local = _mixer(cfg, slot, "dense decode")
    h = norm_apply(cfg, _scale(p, "norm1"), x)
    h, cache = attn.decode_attention(
        cfg, p["attn"], h, cache, pos, local=local, attn_impl=attn_impl
    )
    return _block_tail(cfg, slot, p, x + h), cache


def block_chunk_decode(
    cfg: ArchConfig,
    slot: int,
    p: dict,
    x: torch.Tensor,
    cache: dict,
    start: torch.Tensor,
    length: torch.Tensor,
) -> tuple[torch.Tensor, dict]:
    """Chunk-of-C-tokens block step into the dense cache (DESIGN.md §10)."""
    local = _mixer(cfg, slot, "dense chunk ingestion")
    h = norm_apply(cfg, _scale(p, "norm1"), x)
    h, cache = attn.chunked_decode_attention(
        cfg, p["attn"], h, cache, start, length, local=local
    )
    return _block_tail(cfg, slot, p, x + h), cache
