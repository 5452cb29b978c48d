"""Shared layer primitives on tensors (counterpart of ``repro.models.layers``)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import perf
from repro_torch.configs import ArchConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The reduction in f32; the product too, unless ``perf`` ``norm_bf16``
    keeps it in a sub-f32 residual dtype."""
    dt = x.dtype
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    if perf.current().norm_bf16 and dt != torch.float32:
        return x * r.to(dt) * (1.0 + scale.float()).to(dt)
    return (xf * r * (1.0 + scale.float())).to(dt)


def ln_nonparam(x: torch.Tensor, eps: float) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: no scale, no bias (``norm_bf16`` as
    ``rms_norm``)."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    if perf.current().norm_bf16 and dt != torch.float32:
        return (x - mu.to(dt)) * r.to(dt)
    return ((xf - mu) * r).to(dt)


def norm_apply(
    cfg: ArchConfig, scale: torch.Tensor | None, x: torch.Tensor
) -> torch.Tensor:
    """``scale`` is the rmsnorm weight (None for the non-parametric norm)."""
    if cfg.norm == "rmsnorm":
        return rms_norm(x, scale, cfg.norm_eps)
    return ln_nonparam(x, cfg.norm_eps)


# ------------------------------------------------------------------ softcap
def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# --------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float
) -> torch.Tensor:
    """x: [..., S, H, dh]; positions: [..., S] int. Angles in float32."""
    dh = x.shape[-1]
    freqs = _freqs_on(dh, theta, x.device)  # [dh/2] float32
    angles = positions[..., :, None].float() * freqs  # [..., S, dh/2]
    cos = torch.cos(angles)[..., :, None, :]  # [..., S, 1, dh/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- embeddings
def embed_apply(
    cfg: ArchConfig, params: dict, inputs: torch.Tensor
) -> torch.Tensor:
    """tokens [B,S] -> [B,S,D], or stub-frontend embeddings [B,S,D] passed
    through in the model dtype (``input_kind="embeddings"``)."""
    if cfg.input_kind == "tokens":
        x = params["embed.embedding"][inputs]
    else:
        x = inputs.to(dtype_of(cfg))
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def head_apply(
    cfg: ArchConfig, params: dict, x: torch.Tensor
) -> torch.Tensor:
    """Logits in float32: the product runs in the model dtype, then casts."""
    if cfg.tie_embeddings and cfg.input_kind == "tokens":
        logits = x @ params["embed.embedding"].T
    else:
        logits = x @ params["head.lm_head"]
    return softcap(logits.float(), cfg.final_logit_softcap)
