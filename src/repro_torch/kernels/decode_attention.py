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

On the card (``csrc/paged_decode_split.cuh``, ``paged_decode_split_kernel``,
instantiated in ``paged_attention.cu`` and, for int8 pages,
``paged_attention_int8.cu``) the key range of each ``(row, kv head)`` is
split over the S CTAs of one thread-block cluster ("flash-decoding"): each
CTA reads the row's position and block table itself (where the TPU kernel
prefetched them as scalars), takes its contiguous share of the pages the
row needs (``0..pos//ps``, less pages wholly before the window), and its
warps load K/V rows straight from device memory, 16 bytes a lane, into fp32
online softmaxes in registers. The CTAs' partial softmax states merge
through distributed shared memory in the same launch, so one call is one
launch that allocates nothing. The work is bound by the K/V bytes it reads
(int8: 1 byte per element plus 4 per row for the scale, against bf16's 2);
at the serving shapes those are a few microseconds of HBM, so the design
spreads them over enough CTAs to keep many loads in flight. S comes from
``decode_splits``, a function of static shapes only. Window, softcap,
head_dim, page_size, the query type and the page type are template
parameters: one compiled kernel per specialisation.

B5 (``decode_attention``, replacing ``repro/kernels/decode_attention.py:
decode_attention``) runs the same cluster-split body
(``csrc/decode_attention.cu``, ``dense_decode_split_kernel``) over a dense
``[B, KH, S, dh]`` cache read through strides, in blocks of 16 cache rows
(the table j -> j): the model passes its ``[B, Smax, KH, dh]`` cache
transposed, a view. Its S is ``decode_splits`` over the cache's blocks.
``pos`` is a 0-dim int32 tensor the kernel reads on the device, so the
burst loop never syncs to hand it over.

The wrappers run the plain version only for CPU tensors. For CUDA tensors
they launch the kernel or raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import build
from repro_torch import capture_analysis
from repro_torch.capture_analysis import counted

NEG_INF = -2.0e38
# csrc/paged_decode_split.cuh: a cluster holds 1-8 CTAs (the portable
# cluster size); a CTA holds one query row for G = 1 and TILE_ROWS for G > 1.
MAX_SPLITS = 8
TILE_ROWS = 4
# cache rows a key block of B5 (csrc/paged_attention.cuh: kDenseBlock)
DENSE_BLOCK = 16
# CTAs a decode call aims for: ~4 on each of an H100's 132 SMs. Each CTA
# keeps 8-16 KB of K/V loads in flight; past ~4 a SM, the fixed cost of a
# CTA (its position load, merges and cluster barriers) outweighs the
# parallelism (``chip_smoke.py``'s sweep of S).
TARGET_CTAS = 512


def decode_splits(batch: int, kv_heads: int, group: int,
                  pages_per_row: int) -> int:
    """The CTAs of one cluster that share a row's pages (1-8), from static
    shapes only, so the choice is fixed per dispatch key: enough to bring
    the grid to ``TARGET_CTAS``, and never more than the table's pages."""
    tiles = batch * kv_heads * (1 if group == 1 else -(-group // TILE_ROWS))
    want = -(-TARGET_CTAS // max(tiles, 1))
    return max(1, min(MAX_SPLITS, pages_per_row, want))


def _checked_splits(name, q, k_pages, v_pages, block_tables, splits):
    """S of a B1/B3 launch (``decode_splits`` unless given), after the check
    the kernel's 16-byte loads of K/V rows need: pools 16-byte aligned."""
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{name}: K/V pages must start 16-byte aligned")
    b, h, _ = q.shape
    kh = k_pages.shape[2]
    if splits is None:
        splits = decode_splits(b, kh, h // kh, block_tables.shape[1])
    return splits


@counted(capture_analysis.paged_decode_extent)
def paged_decode_attention(
    q: torch.Tensor,  # [B, H, dh] one token per row
    k_pages: torch.Tensor,  # [P, page_size, KH, dh] pooled pages
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # i32[B, pages_bucket] page ids (0 = null page)
    pos: torch.Tensor,  # i32[B] per-row positions (inclusive)
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    splits: Optional[int] = None,
) -> torch.Tensor:
    """Block-table-gather decode attention over a page pool -> [B, H, dh].
    ``splits`` overrides ``decode_splits`` (the card's kernel only)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, block_tables, pos,
            window=window, softcap=softcap,
        )
    name = "paged_decode_attention"
    build.check_operands(name, q, k_pages, v_pages, block_tables, pos, 3)
    splits = _checked_splits(name, q, k_pages, v_pages, block_tables, splits)
    b, h, dh = q.shape
    _, ps, kh, _ = k_pages.shape
    out = torch.empty_like(q)
    rc = build.load().paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, h, kh, block_tables.shape[1], splits, build.DTYPE_CODES[q.dtype],
        dh, ps,
        int(window is not None), int(window or 0),
        int(softcap is not None), float(softcap or 0.0),
        1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.raise_on_error(name, rc)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0  # kernel launches (CUDA path only)


@counted(capture_analysis.paged_decode_extent)
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
    splits: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention over int8 pages -> [B, H, dh] in q's dtype.
    ``splits`` overrides ``decode_splits`` (the card's kernel only)."""
    if q.device.type == "cpu":
        return paged_decode_attention_int8_plain(
            q, k_pages, v_pages, k_scale, v_scale, block_tables, pos,
            window=window, softcap=softcap,
        )
    name = "paged_decode_attention_int8"
    build.check_operands(
        name, q, k_pages, v_pages, block_tables, pos, 3, k_scale, v_scale
    )
    splits = _checked_splits(name, q, k_pages, v_pages, block_tables, splits)
    b, h, dh = q.shape
    _, ps, kh, _ = k_pages.shape
    out = torch.empty_like(q)
    rc = build.load().paged_decode_attention_int8(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
        pos.data_ptr(), out.data_ptr(), b, h, kh, block_tables.shape[1],
        splits, build.DTYPE_CODES[q.dtype], dh, ps,
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


def _dense_splits(name, q, k, v, splits):
    """S of a B5 launch (``decode_splits`` over the cache's 16-row blocks
    unless given), after the check the kernel's 16-byte loads of K/V rows
    need: k and v 16-byte aligned, with (batch, head, sequence) strides of
    16 bytes' multiples."""
    size = k.element_size()
    if k.data_ptr() % 16 or v.data_ptr() % 16 or any(
        st * size % 16 for st in k.stride()[:3]
    ):
        raise ValueError(
            f"{name}: k/v must start 16-byte aligned with (batch, head, "
            f"sequence) strides of 16-byte multiples, got strides "
            f"{k.stride()} of {size}-byte elements"
        )
    if splits is None:
        b, h, _ = q.shape
        _, kh, seq, _ = k.shape
        splits = decode_splits(b, kh, h // kh, -(-seq // DENSE_BLOCK))
    return splits


@counted(capture_analysis.dense_decode_extent)
def decode_attention(
    q: torch.Tensor,  # [B, H, dh] one token per row
    k: torch.Tensor,  # [B, KH, S, dh] dense cache (any strides, dh unit)
    v: torch.Tensor,
    pos: torch.Tensor,  # i32[] shared cache position (inclusive, < S)
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    splits: Optional[int] = None,
) -> torch.Tensor:
    """Single-token decode over a dense cache at one position -> [B, H, dh].
    ``splits`` overrides ``decode_splits`` (the card's kernel only)."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k, v, pos, window=window, softcap=softcap
        )
    name = "decode_attention"
    build.check_strided_operands(name, q, k, v, 3, {"pos": (pos, ())})
    if k.stride() != v.stride():
        raise ValueError(f"{name}: k and v must share their strides")
    splits = _dense_splits(name, q, k, v, splits)
    b, h, dh = q.shape
    _, kh, seq, _ = k.shape
    out = torch.empty_like(q)
    rc = build.load().dense_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, h, kh, seq, splits, q.stride(0), q.stride(1),
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
