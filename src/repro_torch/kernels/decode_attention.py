"""Decode attention: paged kernels B1 (model-dtype pages) and B3 (int8 pages),
and dense kernel B5 (scalar position): CUDA wrappers, launch counts, plain
versions.

Replace the Pallas TPU kernels
``repro/kernels/decode_attention.py:paged_decode_attention`` and
``paged_decode_attention_int8`` (both through ``_paged_decode_call`` /
``_make_paged_kernel``). One query token per row; its
GQA group ``[G, dh]`` for each kv head attends over the pages listed in
``block_tables[b]``, gathered from a ``[P, ps, KH, dh]`` pool, with the
per-row causal mask ``ki <= pos[b]``, an optional sliding window and logit
softcap, and an online softmax. B3 reads int8 pages and dequantises each
K/V row by its f32 scale (``k_scale``/``v_scale``, ``[P, page_size]``) as it
loads it.

On the card (``csrc/paged_attention.cu``, ``paged_decode_kernel``) one block
serves one ``(row, kv head)``: it reads the row's block table and position
itself (where the TPU kernel prefetched them as scalars), loops over pages
``0..pos//ps`` — skipping pages wholly before the window — staging each
page's K/V in shared memory, and keeps scores, softmax state and the
accumulator in fp32. The work is bound by the K/V bytes it reads from device
memory; the design reads each needed page once per kv head and nothing past
``pos``. Window, softcap, head_dim, page_size, the query type and the page
type are template parameters: one compiled kernel per specialisation; B3 is
the same body with int8 pages (``paged_attention_int8.cu``), so its bytes
per K/V element are 1 instead of 2 (bf16) plus 4 per row for the scale.

B5 (``decode_attention``, replacing ``repro/kernels/decode_attention.py:
decode_attention``) is the same body over a dense ``[B, KH, S, dh]`` cache,
read through strides (``csrc/decode_attention.cu``): the model passes its
``[B, Smax, KH, dh]`` cache transposed, a view. ``pos`` is a 0-dim int32
tensor the kernel reads on the device, so the burst loop never syncs to
hand it over.

The wrappers run the plain version only for CPU tensors. For CUDA tensors
they launch the kernel or raise.
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


def paged_decode_attention_int8(
    q: torch.Tensor,  # [B, H, dh] one token per row
    k_pages: torch.Tensor,  # int8 [P, page_size, KH, dh] quantised pages
    v_pages: torch.Tensor,
    k_scale: torch.Tensor,  # f32 [P, page_size] per-token-row scales
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # i32[B, pages_bucket] page ids (0 = null page)
    pos: torch.Tensor,  # i32[B] per-row positions (inclusive)
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over int8 pages -> [B, H, dh] in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_int8_plain(
            q, k_pages, v_pages, k_scale, v_scale, block_tables, pos,
            window=window, softcap=softcap,
        )
    name = "paged_decode_attention_int8"
    build.check_operands(
        name, q, k_pages, v_pages, block_tables, pos, 3, k_scale, v_scale
    )
    b, h, dh = q.shape
    _, ps, kh, _ = k_pages.shape
    out = torch.empty_like(q)
    rc = build.load().paged_decode_attention_int8(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
        pos.data_ptr(), out.data_ptr(), b, h, kh, block_tables.shape[1],
        build.DTYPE_CODES[q.dtype], dh, ps,
        int(window is not None), int(window or 0),
        int(softcap is not None), float(softcap or 0.0),
        1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.raise_on_error(name, rc)
    paged_decode_attention_int8.launches += 1
    return out


paged_decode_attention_int8.launches = 0  # kernel launches (CUDA path only)


def gather_pages(
    pages: torch.Tensor, block_tables: torch.Tensor, scale=None
) -> torch.Tensor:
    """Each row's pages as one fp32 sequence [B, PB*ps, KH, dh]; int8 pages
    are dequantised by their per-row ``scale`` [P, page_size]."""
    b, pb = block_tables.shape
    _, ps, kh, dh = pages.shape
    g = pages[block_tables].float()  # [B, PB, ps, KH, dh]
    if scale is not None:
        g = g * scale[block_tables][..., None, None]
    return g.reshape(b, pb * ps, kh, dh)


def decode_attention_gathered(
    q: torch.Tensor,  # [B, H, dh]
    gk: torch.Tensor,  # fp32 [B, L, KH, dh] gathered keys
    gv: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Masked fp32 softmax attention of one query per row over its gathered
    K/V -> [B, H, dh] in q's dtype: the body the plain versions share."""
    b, h, dh = q.shape
    seq, kh = gk.shape[1], gk.shape[2]
    qg = q.reshape(b, kh, h // kh, dh).float()
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
    return decode_attention_gathered(
        q, gather_pages(k_pages, block_tables),
        gather_pages(v_pages, block_tables), pos,
        window=window, softcap=softcap,
    )


def paged_decode_attention_int8_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of B3: gather the row's int8 pages, dequantise
    them to fp32 and run the shared body. The counterpart of
    ``paged_decode_attention_int8_reference``, which also rounds the
    dequantised K/V to q's dtype first (a difference only at bf16)."""
    return decode_attention_gathered(
        q, gather_pages(k_pages, block_tables, k_scale),
        gather_pages(v_pages, block_tables, v_scale), pos,
        window=window, softcap=softcap,
    )


def decode_attention(
    q: torch.Tensor,  # [B, H, dh] one token per row
    k: torch.Tensor,  # [B, KH, S, dh] dense cache (any strides, dh unit)
    v: torch.Tensor,
    pos: torch.Tensor,  # i32[] shared cache position (inclusive, < S)
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode over a dense cache at one position -> [B, H, dh]."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k, v, pos, window=window, softcap=softcap
        )
    name = "decode_attention"
    build.check_strided_operands(name, q, k, v, 3, {"pos": (pos, ())})
    if k.stride() != v.stride():
        raise ValueError(f"{name}: k and v must share their strides")
    b, h, dh = q.shape
    _, kh, seq, _ = k.shape
    out = torch.empty_like(q)
    rc = build.load().dense_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, h, kh, seq, q.stride(0), q.stride(1),
        k.stride(0), k.stride(2), k.stride(1), out.stride(0), out.stride(1),
        build.DTYPE_CODES[q.dtype], dh, int(window is not None),
        int(window or 0), int(softcap is not None), float(softcap or 0.0),
        1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.raise_on_error(name, rc)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0  # kernel launches (CUDA path only)


def decode_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of B5, the counterpart of
    ``repro/kernels/ref.py:decode_attention_ref``: every row at ``pos``,
    fp32 scores and softmax, output in q's dtype."""
    return decode_attention_gathered(
        q, k.transpose(1, 2).float(), v.transpose(1, 2).float(),
        pos.reshape(1).expand(q.shape[0]), window=window, softcap=softcap,
    )
