"""AdamW with global-norm clipping and a cosine schedule (the port's copy of
``repro.optim.adamw``), over the port's flat ``dict[str, Tensor]`` params.

The moments are float32 whatever the parameter dtype; the update computes
in float32 and rounds the new parameter back to its own dtype, and the
global norm adds the leaves' squared sums in the JAX tree's leaf order
(``convert.leaf_order``), so the clip scale is the same arithmetic as the
JAX package's. ``step`` is an int32 scalar tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.convert import leaf_order


class AdamWState(NamedTuple):
    step: torch.Tensor  # i32 scalar
    mu: dict  # f32, keyed like params
    nu: dict  # f32, keyed like params


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine decay to ``min_lr_frac``
    of it at ``total_steps`` (float32, like the step)."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clip(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog)
    )
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init(params: dict) -> AdamWState:
    def zeros() -> dict:
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    device = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=zeros(), nu=zeros(),
    )


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 squared sum, leaves added in
    the JAX tree's order."""
    total = None
    for k in leaf_order(tree):
        sq = torch.sum(torch.square(tree[k].to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


_SLAB = 1 << 26  # elements updated at once (256 MB of float32 a temporary)


@torch.no_grad()
def update(
    cfg: AdamWConfig, grads: dict, state: AdamWState, params: dict,
    gnorm: torch.Tensor | None = None,
) -> tuple[dict, AdamWState, dict]:
    """One AdamW step -> (new params, new state, {"grad_norm", "lr"}). The
    params' and moments' tensors are overwritten in place and returned (the
    JAX step's donated buffers), so the state is never held twice. Each
    leaf is updated in slabs of ``_SLAB`` elements: the arithmetic is
    elementwise, so a slab's is the whole leaf's, and the float32
    temporaries stay a few slabs however large the leaf. ``gnorm`` is the
    whole gradient's global norm where ``grads`` are one mesh
    coordinate's pieces of it (``distributed.fsdp``); by default
    ``global_norm(grads)``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        mu, nu = state.mu[k], state.nu[k]
        # views: each leaf is written through them
        flat = [p.view(-1), grads[k].reshape(-1), mu.view(-1), nu.view(-1)]
        for i in range(0, p.numel(), _SLAB):
            p_, g_, m_, v_ = (t[i:i + _SLAB] for t in flat)
            g = g_.to(torch.float32) * scale
            m = cfg.b1 * m_ + (1 - cfg.b1) * g
            v = cfg.b2 * v_ + (1 - cfg.b2) * torch.square(g)
            pf = p_.to(torch.float32)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + (
                cfg.weight_decay * pf)
            p_.copy_(pf - lr * delta)
            m_.copy_(m)
            v_.copy_(v)
        new_p[k], new_m[k], new_v[k] = p, mu, nu
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v), metrics
