"""GQA attention through a paged KV cache (counterpart of
``repro.models.attention``'s paged functions).

Pages are updated **in place** (``index_put_``), where the JAX package
returns a functionally updated cache: the pooled ``[P, page_size, KH, dh]``
pages are the largest tensors of the serving path, and a copy per step would
double their traffic. The functions still return the cache, so call sites
read like the JAX ones.

The read side has two implementations, chosen semi-statically when a step
is built (``attn_impl``), never per call:

* ``"kernel"`` (default) — the paged attention kernels of
  ``repro_torch.kernels`` (B1 decode, B2 prefill): hand-written CUDA on the
  card, their plain versions on the CPU;
* ``"plain"`` — gather the row's pages and run ``_decode_sdpa_rows``, the JAX
  package's own tail (QK product in the model dtype, then f32 softmax).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs import ArchConfig

from .layers import apply_rope, dtype_of, rms_norm, softcap

NEG_INF = -2.0e38
ATTN_IMPLS = ("kernel", "plain")


def _qkv(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """x [B,S,D] -> q [B,S,H,dh], k/v [B,S,KH,dh], rope applied."""
    b, s, d = x.shape
    q = (x @ p["wq"].reshape(d, -1)).view(b, s, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"].reshape(d, -1)).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"].reshape(d, -1)).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_scale"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(cfg: ArchConfig, p: dict, o: torch.Tensor) -> torch.Tensor:
    """o [B,S,H,dh] -> [B,S,D] through wo [H,dh,D]."""
    b, s = o.shape[:2]
    return o.reshape(b, s, cfg.q_dim) @ p["wo"].reshape(cfg.q_dim, -1)


def _decode_sdpa_rows(
    cfg: ArchConfig,
    p: dict,
    q: torch.Tensor,
    keys: torch.Tensor,
    vals: torch.Tensor,
    pos: torch.Tensor,
    *,
    local: bool,
) -> torch.Tensor:
    """Per-row masked SDPA tail: q [B,Sq,H,dh]; keys/vals [B,L,KH,dh] (each
    row's gathered pages); pos i32[B] (one query per row) or i32[B,Sq]
    (per-query causal frontiers). Returns the projected output [B,Sq,D]."""
    b, sq = q.shape[:2]
    g = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, sq, cfg.num_kv_heads, g, cfg.head_dim)
    scale = 1.0 / np.sqrt(cfg.head_dim)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, keys).float() * scale
    scores = softcap(scores, cfg.attn_logit_softcap)
    ki = torch.arange(keys.shape[1], device=q.device)
    window = cfg.sliding_window if local else None
    if pos.dim() == 2:  # [B,Sq]: each chunk row has its own causal frontier
        ok = ki[None, None, :] <= pos[:, :, None]  # [B,Sq,L]
        if window is not None:
            ok &= ki[None, None, :] > pos[:, :, None] - window
        mask = torch.where(ok, 0.0, NEG_INF)[:, None, None, :, :]
    else:
        ok = ki[None, :] <= pos[:, None]  # [B,L]
        if window is not None:
            ok &= ki[None, :] > pos[:, None] - window
        mask = torch.where(ok, 0.0, NEG_INF)[:, None, None, None, :]
    probs = torch.softmax(scores + mask, dim=-1).to(vals.dtype)
    og = torch.einsum("bhgqk,bkhd->bqhgd", probs, vals)
    return _out_proj(cfg, p, og.reshape(b, sq, cfg.num_heads, cfg.head_dim))


def init_paged_kv_cache(
    cfg: ArchConfig,
    num_pages: int,
    page_size: int,
    device: torch.device | str = "cpu",
) -> dict:
    """Pooled KV pages shared by every request (DESIGN.md §9), in the model
    dtype (the JAX package's ``kv_dtype="fp32"``; int8 pages are ported with
    kernels B3/B4). ``num_pages`` counts physical pages including the
    reserved null page 0."""
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    dt = dtype_of(cfg)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def _gather_pages(cfg: ArchConfig, cache: dict, block_tables: torch.Tensor):
    b, pb = block_tables.shape
    seq = pb * cache["k"].shape[1]
    shape = (b, seq, cfg.num_kv_heads, cfg.head_dim)
    return (
        cache["k"][block_tables].reshape(shape),
        cache["v"][block_tables].reshape(shape),
    )


def paged_decode_attention(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,
    cache: dict,
    pos: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    local: bool,
    attn_impl: str = "kernel",
) -> tuple[torch.Tensor, dict]:
    """One-token decode through a paged KV cache.

    x: [B,1,D]; cache k/v: [P, page_size, KH, dh]; ``block_tables``:
    i32[B, pages_bucket] (0 = the null page); ``pos``: i32[B].

    Writes the new K/V row in place into ``pages[bt[b, pos//ps], pos%ps]``
    (the page index clipped to the bucket, as in the JAX package; inactive
    slots carry all-null tables, so their writes land in the null page),
    then attends over the row's pages.
    """
    ps = cache["k"].shape[1]
    pages_bucket = block_tables.shape[1]
    q, k, v = _qkv(cfg, p, x, pos[:, None])
    page_idx = (pos // ps).clamp(0, pages_bucket - 1).long()
    wpage = block_tables.gather(1, page_idx[:, None])[:, 0]
    woff = pos % ps
    cache["k"].index_put_((wpage, woff), k[:, 0])
    cache["v"].index_put_((wpage, woff), v[:, 0])
    if attn_impl == "kernel":
        o = kernels.paged_decode_attention(
            q[:, 0], cache["k"], cache["v"], block_tables, pos,
            window=cfg.sliding_window if local else None,
            softcap=cfg.attn_logit_softcap,
        )
        return _out_proj(cfg, p, o[:, None]), cache
    gk, gv = _gather_pages(cfg, cache, block_tables)
    return _decode_sdpa_rows(cfg, p, q, gk, gv, pos, local=local), cache


def paged_prefill_attention(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,
    cache: dict,
    start: torch.Tensor,
    block_tables: torch.Tensor,
    length: torch.Tensor,
    *,
    local: bool,
    attn_impl: str = "kernel",
) -> tuple[torch.Tensor, dict]:
    """Chunk-of-C-tokens prompt ingestion through the paged KV cache.

    x: [B,C,D]; ``start``: i32[B] position of each row's first chunk token;
    ``length``: i32[B] real tokens (columns >= length are bucket padding).
    Writes all C K/V rows in place through the block table — page indices
    clipped to the bucket, padded columns redirected to the null page 0 —
    then attends causally: chunk row i sees positions <= start + i, which
    covers the cached prefix and the chunk's own rows.
    """
    c = x.shape[1]
    ps = cache["k"].shape[1]
    pages_bucket = block_tables.shape[1]
    offs = torch.arange(c, dtype=torch.int32, device=x.device)
    positions = start[:, None] + offs[None, :]  # [B,C]
    q, k, v = _qkv(cfg, p, x, positions)
    page_idx = (positions // ps).clamp(0, pages_bucket - 1).long()
    wpage = block_tables.gather(1, page_idx)  # [B,C]
    wpage = torch.where(offs[None, :] < length[:, None], wpage, 0)
    woff = positions % ps
    cache["k"].index_put_((wpage, woff), k)
    cache["v"].index_put_((wpage, woff), v)
    if attn_impl == "kernel":
        o = kernels.paged_prefill_attention(
            q, cache["k"], cache["v"], block_tables, start,
            window=cfg.sliding_window if local else None,
            softcap=cfg.attn_logit_softcap,
        )
        return _out_proj(cfg, p, o), cache
    gk, gv = _gather_pages(cfg, cache, block_tables)
    return _decode_sdpa_rows(cfg, p, q, gk, gv, positions, local=local), cache
