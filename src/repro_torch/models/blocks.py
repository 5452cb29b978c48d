"""Attention/Mamba2 + MLP blocks: full sequence, through the paged KV cache,
and through the dense cache (counterpart of ``repro.models.blocks``). Mamba
slots serve the full-sequence path and the dense (recurrent-state) decode;
the paged and chunk entry points are attention-only."""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig

from . import attention as attn
from . import mlp as mlp_mod
from . import ssm as ssm_mod
from .layers import norm_apply


def _mixer(cfg: ArchConfig, slot: int, what: str) -> bool:
    """Attention slots only; returns whether the slot's mixer is local.
    ``what`` completes the JAX package's refusal of a mamba slot."""
    mixer = cfg.mixer_at(slot)
    if not mixer.startswith("attn"):
        raise ValueError(f"{cfg.name}: slot {slot} mixer {mixer!r}: {what}")
    return mixer == "attn_local"


def _is_ssm(cfg: ArchConfig, slot: int) -> bool:
    return cfg.mixer_at(slot) == "mamba"


def _is_local(cfg: ArchConfig, slot: int) -> bool:
    return cfg.mixer_at(slot) == "attn_local"


def check_paged_slot(cfg: ArchConfig, slot: int) -> None:
    """The paged KV cache holds attention K/V only (DESIGN.md §9)."""
    mixer = cfg.mixer_at(slot)
    if not mixer.startswith("attn"):
        raise ValueError(
            f"{cfg.name}: slot {slot} mixer {mixer!r} has recurrent state; "
            f"the paged KV path supports attention-only stacks."
        )


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
    """Full-sequence block (``forward``); ``impl`` picks the attention, or
    for a mamba slot the SSD scan (``"kernel"`` B8, else ``ssd_scan``)."""
    h = norm_apply(cfg, _scale(p, "norm1"), x)
    if _is_ssm(cfg, slot):
        h, _ = ssm_mod.ssm_apply(cfg, p["ssm"], h, impl=impl)
    else:
        h = attn.attention(
            cfg, p["attn"], h, positions,
            local=_is_local(cfg, slot), impl=impl,
        )
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
    """Full-sequence block that also emits this slot's cache entry (a
    mamba slot's ``{conv, state}``)."""
    h = norm_apply(cfg, _scale(p, "norm1"), x)
    if _is_ssm(cfg, slot):
        h, cache = ssm_mod.ssm_apply(
            cfg, p["ssm"], h, return_cache=True, impl=impl
        )
    else:
        h, cache = attn.prefill_attention(
            cfg, p["attn"], h, positions,
            local=_is_local(cfg, slot), impl=impl,
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
    local = _mixer(
        cfg, slot,
        "paged decode is attention-only (see check_paged_slot).",
    )
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
    local = _mixer(
        cfg, slot,
        "paged prefill is attention-only (see check_paged_slot).",
    )
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
    """One slot's dense per-slot cache: KV rows, or a mamba slot's conv
    window and state (model-dtype only)."""
    if not _is_ssm(cfg, slot):
        return attn.init_kv_cache(cfg, batch, max_len, kv_dtype, device)
    if kv_dtype != "fp32":
        raise ValueError(
            f"{cfg.name}: slot {slot} mixer {cfg.mixer_at(slot)!r} has "
            f"recurrent state; quantised dense KV is attention-only."
        )
    return ssm_mod.init_ssm_cache(cfg, batch, device)


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
    (the burst engine) or per-row positions (the draft); a mamba slot
    ignores ``pos`` and steps its recurrent state."""
    h = norm_apply(cfg, _scale(p, "norm1"), x)
    if _is_ssm(cfg, slot):
        h, cache = ssm_mod.ssm_decode_step(cfg, p["ssm"], h, cache)
    else:
        h, cache = attn.decode_attention(
            cfg, p["attn"], h, cache, pos,
            local=_is_local(cfg, slot), attn_impl=attn_impl,
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
    local = _mixer(
        cfg, slot,
        "chunked prefill is attention-only; teacher-force SSM stacks token "
        "by token.",
    )
    h = norm_apply(cfg, _scale(p, "norm1"), x)
    h, cache = attn.chunked_decode_attention(
        cfg, p["attn"], h, cache, start, length, local=local
    )
    return _block_tail(cfg, slot, p, x + h), cache
