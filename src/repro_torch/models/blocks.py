"""Paged attention + MLP blocks (counterpart of ``repro.models.blocks``)."""

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
