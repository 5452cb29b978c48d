"""Paged prefill attention, kernels B2 (model-dtype pages) and B4 (int8
pages): CUDA wrappers, launch counts, plain versions.

Replace the Pallas TPU kernels
``repro/kernels/prefill_attention.py:paged_prefill_attention`` and
``paged_prefill_attention_int8`` (through ``_paged_prefill_call`` /
``_make_prefill_kernel``; the verify lane's aliases
``paged_verify_attention`` / ``paged_verify_attention_int8`` are the same
functions, with a chunk of K+1 rows). A chunk of C query tokens
per row attends over the row's pages, which already hold the chunk's own K/V;
chunk row ``i`` is causal at ``start[b] + i``, with an optional sliding
window and logit softcap. B4 reads int8 pages and dequantises each K/V row
by its f32 scale as it loads it.

On the card (``csrc/paged_attention.cu``, ``paged_prefill_kernel``) the
chunk's rows of one kv head are packed as ``[C·G, dh]`` — row ``r`` is chunk
token ``r // G`` — and one block serves one ``(row, kv head, tile of 16
packed rows)``. It loops over pages up to the tile's last causal frontier
(the block table is ``max_pages_per_req`` wide, so the skip is what keeps the
work proportional to the prompt) and, in window mode, from its first row's
window; K/V pages stage in shared memory and the softmax runs in fp32. The
work is bound by the K/V bytes read; each tile reads only the pages its
rows can see. Window, softcap, head_dim, page_size, the query type and the
page type are template parameters; B4 is the same body with int8 pages
(``paged_attention_int8.cu``).

The wrappers run the plain version only for CPU tensors. For CUDA tensors
they launch the kernel or raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import build
from .decode_attention import gather_pages

NEG_INF = -2.0e38


def paged_prefill_attention(
    q: torch.Tensor,  # [B, C, H, dh] one chunk of C query tokens per row
    k_pages: torch.Tensor,  # [P, page_size, KH, dh] pooled pages (chunk written)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # i32[B, pages_bucket] page ids (0 = null page)
    start: torch.Tensor,  # i32[B] position of each row's first chunk token
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention of a query chunk over its row's pages -> [B, C, H, dh]."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_pages, v_pages, block_tables, start,
            window=window, softcap=softcap,
        )
    name = "paged_prefill_attention"
    build.check_operands(name, q, k_pages, v_pages, block_tables, start, 4)
    b, c, h, dh = q.shape
    _, ps, kh, _ = k_pages.shape
    out = torch.empty_like(q)
    rc = build.load().paged_prefill_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), start.data_ptr(), out.data_ptr(),
        b, c, h, kh, block_tables.shape[1], build.DTYPE_CODES[q.dtype], dh, ps,
        int(window is not None), int(window or 0),
        int(softcap is not None), float(softcap or 0.0),
        1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.raise_on_error(name, rc)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0  # kernel launches (CUDA path only)


def paged_prefill_attention_int8(
    q: torch.Tensor,  # [B, C, H, dh] one chunk of C query tokens per row
    k_pages: torch.Tensor,  # int8 [P, page_size, KH, dh] (chunk written)
    v_pages: torch.Tensor,
    k_scale: torch.Tensor,  # f32 [P, page_size] per-token-row scales
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # i32[B, pages_bucket] page ids (0 = null page)
    start: torch.Tensor,  # i32[B] position of each row's first chunk token
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal chunk attention over int8 pages -> [B, C, H, dh] in q's dtype."""
    if q.device.type == "cpu":
        return paged_prefill_attention_int8_plain(
            q, k_pages, v_pages, k_scale, v_scale, block_tables, start,
            window=window, softcap=softcap,
        )
    name = "paged_prefill_attention_int8"
    build.check_operands(
        name, q, k_pages, v_pages, block_tables, start, 4, k_scale, v_scale
    )
    b, c, h, dh = q.shape
    _, ps, kh, _ = k_pages.shape
    out = torch.empty_like(q)
    rc = build.load().paged_prefill_attention_int8(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
        start.data_ptr(), out.data_ptr(), b, c, h, kh, block_tables.shape[1],
        build.DTYPE_CODES[q.dtype], dh, ps,
        int(window is not None), int(window or 0),
        int(softcap is not None), float(softcap or 0.0),
        1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.raise_on_error(name, rc)
    paged_prefill_attention_int8.launches += 1
    return out


paged_prefill_attention_int8.launches = 0  # kernel launches (CUDA path only)


def prefill_attention_gathered(
    q: torch.Tensor,  # [B, C, H, dh]
    gk: torch.Tensor,  # fp32 [B, L, KH, dh] gathered keys
    gv: torch.Tensor,
    start: torch.Tensor,
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Per-row causal fp32 softmax attention of a chunk over its gathered
    K/V -> [B, C, H, dh] in q's dtype: the body the plain versions share."""
    b, c, h, dh = q.shape
    seq, kh = gk.shape[1], gk.shape[2]
    qg = q.reshape(b, c, kh, h // kh, dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, gk) * (1.0 / math.sqrt(dh))
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    ki = torch.arange(seq, device=q.device)[None, None, :]
    qi = start.long()[:, None, None] + torch.arange(c, device=q.device)[
        None, :, None
    ]
    ok = ki <= qi  # [B, C, L]
    if window is not None:
        ok &= ki > qi - window
    s = torch.where(ok[:, None, None, :, :], s, NEG_INF)
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), gv)
    return o.reshape(b, c, h, dh).to(q.dtype)


def paged_prefill_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    start: torch.Tensor,
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version (gather + per-row causal masked softmax, fp32),
    the counterpart of ``paged_prefill_attention_reference``."""
    return prefill_attention_gathered(
        q, gather_pages(k_pages, block_tables),
        gather_pages(v_pages, block_tables), start,
        window=window, softcap=softcap,
    )


def paged_prefill_attention_int8_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,
    start: torch.Tensor,
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of B4: gather the row's int8 pages, dequantise
    them to fp32 and run the shared body. The counterpart of
    ``paged_prefill_attention_int8_reference``, which also rounds the
    dequantised K/V to q's dtype first (a difference only at bf16)."""
    return prefill_attention_gathered(
        q, gather_pages(k_pages, block_tables, k_scale),
        gather_pages(v_pages, block_tables, v_scale), start,
        window=window, softcap=softcap,
    )
