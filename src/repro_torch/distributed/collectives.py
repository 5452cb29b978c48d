"""Gradient compression for the trainer (the port's copy of the compressor
half of ``repro.distributed.collectives``), over dicts of tensors.

``quantize_tree`` / ``dequantize_tree`` are int8 quantisation with one
float32 scale per leaf; ``make_grad_compressor`` is the trainer's
``grad_compress`` hook (int8 or bf16, with an error-feedback residual so
repeated compression does not bias the optimiser). The JAX package's
``compressed_psum`` is an all-reduce over a device mesh and waits for the
mesh layer (ROADMAP A12).
"""

from __future__ import annotations

from typing import Callable

import torch


def _qparams(x: torch.Tensor) -> torch.Tensor:
    amax = torch.max(torch.abs(x))
    return torch.clamp(amax, min=1e-12) / 127.0


def _quantize(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Round half to even, as ``jnp.round``, into [-127, 127]."""
    return torch.clip(torch.round(x / s), -127, 127).to(torch.int8)


def quantize_tree(tree: dict) -> tuple[dict, dict]:
    """-> (int8 dict, float32 scale dict)."""
    qs, ss = {}, {}
    for k, x in tree.items():
        xf = x.to(torch.float32)
        ss[k] = _qparams(xf)
        qs[k] = _quantize(xf, ss[k])
    return qs, ss


def dequantize_tree(qs: dict, ss: dict) -> dict:
    return {k: q.to(torch.float32) * ss[k] for k, q in qs.items()}


def make_grad_compressor(
    bits: int = 8, error_feedback: bool = True
) -> tuple[Callable, Callable]:
    """Returns (compress_fn, init_residual_fn) for the trainer hook.

    compress_fn(grads, residual) -> (grads_hat, new_residual): quantises the
    gradient (plus carried residual) and keeps the quantisation error for
    the next step. With error_feedback=False the residual stays zero."""
    if bits not in (8, 16):
        raise ValueError(f"bits must be 8 or 16, got {bits}")

    def init_residual(grads: dict) -> dict:
        return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for k, g in grads.items()}

    def compress(grads: dict, residual: dict) -> tuple[dict, dict]:
        ghat, new_r = {}, {}
        for k, g in grads.items():
            gf = g.to(torch.float32) + residual[k]
            if bits == 16:
                h = gf.to(torch.bfloat16).to(torch.float32)
            else:
                s = _qparams(gf)
                h = _quantize(gf, s).to(torch.float32) * s
            new_r[k] = gf - h if error_feedback else torch.zeros_like(gf)
            ghat[k] = h.to(g.dtype)
        return ghat, new_r

    return compress, init_residual
