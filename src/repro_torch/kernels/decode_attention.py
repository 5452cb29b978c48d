"""Paged decode attention, kernel B1: CUDA wrapper, launch count, plain version.

Replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py:paged_decode_attention`` (through
``_paged_decode_call`` / ``_make_paged_kernel``). One query token per row; its
GQA group ``[G, dh]`` for each kv head attends over the pages listed in
``block_tables[b]``, gathered from a ``[P, ps, KH, dh]`` pool, with the
per-row causal mask ``ki <= pos[b]``, an optional sliding window and logit
softcap, and an online softmax.

On the card (``csrc/paged_attention.cu``, ``paged_decode_kernel``) one block
serves one ``(row, kv head)``: it reads the row's block table and position
itself (where the TPU kernel prefetched them as scalars), loops over pages
``0..pos//ps`` — skipping pages wholly before the window — staging each
page's K/V in shared memory, and keeps scores, softmax state and the
accumulator in fp32. The work is bound by the K/V bytes it reads from device
memory; the design reads each needed page once per kv head and nothing past
``pos``. Window, softcap, head_dim, page_size and the element type are
template parameters: one compiled kernel per specialisation.

The wrapper runs the plain version only for CPU tensors. For CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import build

NEG_INF = -2.0e38


def paged_decode_attention(
    q: torch.Tensor,  # [B, H, dh] one token per row
    k_pages: torch.Tensor,  # [P, page_size, KH, dh] pooled pages
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # i32[B, pages_bucket] page ids (0 = null page)
    pos: torch.Tensor,  # i32[B] per-row positions (inclusive)
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Block-table-gather decode attention over a page pool -> [B, H, dh]."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, block_tables, pos,
            window=window, softcap=softcap,
        )
    name = "paged_decode_attention"
    build.check_operands(name, q, k_pages, v_pages, block_tables, pos, 3)
    b, h, dh = q.shape
    _, ps, kh, _ = k_pages.shape
    out = torch.empty_like(q)
    rc = build.load().paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, h, kh, block_tables.shape[1], build.DTYPE_CODES[q.dtype], dh, ps,
        int(window is not None), int(window or 0),
        int(softcap is not None), float(softcap or 0.0),
        1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.raise_on_error(name, rc)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0  # kernel launches (CUDA path only)


def paged_decode_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version (gather + masked softmax, fp32), the counterpart
    of ``paged_decode_attention_reference`` in the JAX package."""
    b, h, dh = q.shape
    _, page_size, kh, _ = k_pages.shape
    seq = block_tables.shape[1] * page_size
    group = h // kh
    gk = k_pages[block_tables].reshape(b, seq, kh, dh).float()
    gv = v_pages[block_tables].reshape(b, seq, kh, dh).float()
    qg = q.reshape(b, kh, group, dh).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, gk) * (1.0 / math.sqrt(dh))
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    ki = torch.arange(seq, device=q.device)[None, :]
    p = pos.long()[:, None]
    ok = ki <= p
    if window is not None:
        ok &= ki > p - window
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    o = torch.einsum("bhgk,bkhd->bhgd", torch.softmax(s, dim=-1), gv)
    return o.reshape(b, h, dh).to(q.dtype)
