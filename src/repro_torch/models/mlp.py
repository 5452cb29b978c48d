"""Gated MLP (SwiGLU / GeGLU), counterpart of ``repro.models.mlp``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if name == "silu" else F.gelu(x, approximate="tanh")


def mlp_apply(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """p: one layer's {"w_gate": [D,F], "w_up": [D,F], "w_down": [F,D]}."""
    g = _act(cfg.act, x @ p["w_gate"])
    u = x @ p["w_up"]
    return (g * u) @ p["w_down"]
