"""Full-sequence flash attention, kernels B6 (mode-specialised) and B7 (mode
as runtime flags): CUDA wrappers, launch counts, plain versions.

Replace the Pallas TPU kernels ``repro/kernels/flash_attention.py:
flash_attention`` and ``flash_attention_branchy``. Both compute GQA
attention of ``q [B, H, Sq, dh]`` over ``k, v [B, KH, Sk, dh]`` with the
causal mask, an optional sliding window and logit softcap, an fp32 online
softmax and an output in q's dtype; the mask positions are the query and key
indices from 0, as in the Pallas kernels and ``ref.py:attention_ref``.

On the card (``csrc/flash_attention.cu``) one block serves one (row, query
head, tile of 16 queries) and walks the key tiles itself. B6 bakes causal,
window and softcap into the compiled kernel and never loads a key tile the
mask removes whole; B7 reads ``flags = (causal, window|0, softcap|0)`` (an
int32[3] tensor, the cap an integer as in the Pallas kernel) on the device,
visits every tile and computes every mode's work before selecting — the
paper's conditional baseline, which ``KernelBranch`` sets beside B6
(``kernels/ops.py``). Tensors are read and written through their strides
(``dh`` needs a unit stride), so the model hands over ``[B, S, H, dh]``
activations as transposed views and receives its output in that layout, and
ragged sequence lengths are masked.

The wrappers run the plain version only for CPU tensors. For CUDA tensors
they launch the kernel or raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import build
from .decode_attention import NEG_INF


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, head, sequence) element strides of a [B, H, S, dh] tensor."""
    return t.stride(0), t.stride(1), t.stride(2)


def _launch_args(q, k, v, out) -> tuple:
    b, h, sq, dh = q.shape
    _, kh, sk, _ = k.shape
    return (
        b, h, kh, sq, sk, *_strides(q), *_strides(k), *_strides(v),
        *_strides(out),
    )


def flash_attention(
    q: torch.Tensor,  # [B, H, Sq, dh]
    k: torch.Tensor,  # [B, KH, Sk, dh]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Specialised flash attention -> [B, H, Sq, dh] with q's strides."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap
        )
    name = "flash_attention"
    build.check_strided_operands(name, q, k, v, 4, {})
    out = torch.empty_like(q)
    dh = q.shape[-1]
    rc = build.load().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *_launch_args(q, k, v, out), build.DTYPE_CODES[q.dtype], dh,
        int(causal), int(window is not None), int(window or 0),
        int(softcap is not None), float(softcap or 0.0), 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.raise_on_error(name, rc)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches (CUDA path only)


def flash_attention_branchy(
    q: torch.Tensor,  # [B, H, Sq, dh]
    k: torch.Tensor,  # [B, KH, Sk, dh]
    v: torch.Tensor,
    flags: torch.Tensor,  # i32[3]: (causal, window|0, softcap|0)
) -> torch.Tensor:
    """Runtime-flag flash attention -> [B, H, Sq, dh] with q's strides."""
    if q.device.type == "cpu":
        return flash_attention_branchy_plain(q, k, v, flags)
    name = "flash_attention_branchy"
    build.check_strided_operands(name, q, k, v, 4, {"flags": (flags, (3,))})
    out = torch.empty_like(q)
    dh = q.shape[-1]
    rc = build.load().flash_attention_branchy(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), flags.data_ptr(),
        out.data_ptr(), *_launch_args(q, k, v, out),
        build.DTYPE_CODES[q.dtype], dh, 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.raise_on_error(name, rc)
    flash_attention_branchy.launches += 1
    return out


flash_attention_branchy.launches = 0  # kernel launches (CUDA path only)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 scores [B, KH, G, Sq, Sk] of q [B, H, Sq, dh] against k."""
    b, h, sq, dh = q.shape
    kh = k.shape[1]
    qg = q.reshape(b, kh, h // kh, sq, dh).float()
    return torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(dh)


def _attend(q, s, ok, v) -> torch.Tensor:
    """Masked softmax of scores ``s`` (``ok`` [Sq, Sk]) times v, in q's
    dtype and shape."""
    s = torch.where(ok, s, NEG_INF)
    o = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(s, dim=-1), v.float())
    return o.reshape(q.shape).to(q.dtype)


def _positions(q, k) -> tuple[torch.Tensor, torch.Tensor]:
    qi = torch.arange(q.shape[2], device=q.device)[:, None]
    ki = torch.arange(k.shape[2], device=q.device)[None, :]
    return qi, ki


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of B6, the counterpart of
    ``repro/kernels/ref.py:attention_ref``."""
    s = _scores(q, k)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qi, ki = _positions(q, k)
    ok = torch.ones(qi.shape[0], ki.shape[1], dtype=torch.bool, device=q.device)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    return _attend(q, s, ok, v)


def flash_attention_branchy_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    flags: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of B7: the Pallas branchy body's selects on the
    flags as tensor ops (the capped and uncapped scores both computed)."""
    causal_f, window_f, softcap_f = flags.long().to(q.device).unbind()
    s = _scores(q, k)
    cap = softcap_f.float().clamp_min(1.0)
    s = torch.where(softcap_f > 0, torch.tanh(s / cap) * cap, s)
    qi, ki = _positions(q, k)
    ok = ((causal_f == 0) | (ki <= qi)) & ((window_f == 0) | (ki > qi - window_f))
    return _attend(q, s, ok, v)
