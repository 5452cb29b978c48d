"""GQA attention through a paged KV cache, and the speculative draft's dense
per-slot cache (counterpart of ``repro.models.attention``'s paged, per-row
decode and chunked functions).

Pages are updated **in place** (``index_put_``), where the JAX package
returns a functionally updated cache: the pooled ``[P, page_size, KH, dh]``
pages are the largest tensors of the serving path, and a copy per step would
double their traffic. The functions still return the cache, so call sites
read like the JAX ones.

The read side has two implementations, chosen semi-statically when a step
is built (``attn_impl``), never per call:

* ``"kernel"`` (default) — the paged attention kernels of
  ``repro_torch.kernels`` (B1 decode, B2 prefill over model-dtype pages; B3,
  B4 over int8 pages): hand-written CUDA on the card, their plain versions
  on the CPU;
* ``"plain"`` — gather the row's pages (dequantised to f32 for int8) and run
  ``_decode_sdpa_rows``, the JAX package's own tail (QK product in the
  keys' dtype, then f32 softmax).

Pages are stored in the model dtype (``kv_dtype="fp32"``, the JAX package's
name for it) or as int8 with one f32 scale per token row
(``kv_dtype="int8"``, DESIGN.md §12); the page dtype is a dispatch
coordinate, so a step built for one never sees the other.

**The int8 dtype rule.** int8 attention computes in f32 and its output is
cast to the model dtype before ``wo``, so the residual stream keeps the
model dtype. The kernels do this by construction (their output has q's
dtype, as ``o_ref`` has in the Pallas kernels); the plain tail casts. At
fp32 this is exactly the JAX package's arithmetic. At bf16 the JAX
package's int8 paths promote the residual stream to f32 and fail to trace,
so there the port's rule has no JAX counterpart.

The draft lanes' dense cache (``init_kv_cache``, ``decode_attention``,
``chunked_decode_attention``) is plain PyTorch: the JAX package has no
Pallas kernel for the per-row dense path either.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs import ArchConfig
from repro_torch.runtime.kvcache import KV_DTYPES

from .layers import apply_rope, dtype_of, rms_norm, softcap

NEG_INF = -2.0e38
ATTN_IMPLS = ("kernel", "plain")
# int8 KV quantisation range (DESIGN.md §12): symmetric, full int8 span.
KV_QUANT_MAX = 127.0
KV_SCALE_EPS = 1e-8  # all-zero rows quantise with a tiny non-zero scale


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
    (per-query causal frontiers). Returns the projected output [B,Sq,D].

    Keys/values dequantised from int8 arrive in f32: the products then run
    in f32 and the attention output is cast to the model dtype before
    ``wo`` (the int8 dtype rule; a no-op for model-dtype keys)."""
    b, sq = q.shape[:2]
    g = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, sq, cfg.num_kv_heads, g, cfg.head_dim).to(keys.dtype)
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
    og = torch.einsum("bhgqk,bkhd->bqhgd", probs, vals).to(q.dtype)
    return _out_proj(cfg, p, og.reshape(b, sq, cfg.num_heads, cfg.head_dim))


def quantise_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token-row symmetric int8 quantisation (DESIGN.md §12).

    ``x``: ``[..., KH, dh]`` K or V rows. Each row (one token's heads × dims)
    gets its own absmax scale ``max(amax / 127, 1e-8)`` in f32, then
    ``round`` (half to even, as ``jnp.round``) and ``clip`` to ±127. Returns
    ``(q int8[..., KH, dh], scale f32[...])``: the same bits as the JAX
    package's ``quantise_kv_rows``. One implementation for every lane's
    write, so chunked and token-by-token ingestion write the same bits."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    scale = torch.clamp_min(amax / KV_QUANT_MAX, KV_SCALE_EPS)
    q = torch.clamp(
        torch.round(xf / scale[..., None, None]), -KV_QUANT_MAX, KV_QUANT_MAX
    ).to(torch.int8)
    return q, scale


def dequantise_kv_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantise_kv_rows``: int8 rows × their scales -> f32."""
    return q.float() * scale[..., None, None]


def _check_kv_dtype(kv_dtype: str) -> None:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")


def init_paged_kv_cache(
    cfg: ArchConfig,
    num_pages: int,
    page_size: int,
    kv_dtype: str = "fp32",
    device: torch.device | str = "cpu",
) -> dict:
    """Pooled KV pages shared by every request (DESIGN.md §9). ``num_pages``
    counts physical pages including the reserved null page 0.

    ``kv_dtype="fp32"`` stores pages in the model dtype; ``"int8"`` stores
    int8 pages plus f32 per-token-row scales ``k_scale``/``v_scale`` of
    shape ``[P, page_size]``, which share the page axis (so copy-on-write
    moves them with the pages)."""
    _check_kv_dtype(kv_dtype)
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    if kv_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:2], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:2], dtype=torch.float32, device=device),
        }
    dt = dtype_of(cfg)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def _write_pages(cache: dict, wpage, woff, k: torch.Tensor, v: torch.Tensor):
    """In-place write of K/V rows at ``pages[wpage, woff]`` (quantised with
    their scales for an int8 pool)."""
    if cache["k"].dtype == torch.int8:
        qk, ksc = quantise_kv_rows(k)
        qv, vsc = quantise_kv_rows(v)
        cache["k"].index_put_((wpage, woff), qk)
        cache["v"].index_put_((wpage, woff), qv)
        cache["k_scale"].index_put_((wpage, woff), ksc)
        cache["v_scale"].index_put_((wpage, woff), vsc)
    else:
        cache["k"].index_put_((wpage, woff), k)
        cache["v"].index_put_((wpage, woff), v)


def _gather_pages(cfg: ArchConfig, cache: dict, block_tables: torch.Tensor):
    """Each row's pages as one sequence [B, PB*ps, KH, dh]: model dtype, or
    f32 dequantised from an int8 pool."""
    b, pb = block_tables.shape
    seq = pb * cache["k"].shape[1]
    shape = (b, seq, cfg.num_kv_heads, cfg.head_dim)
    if cache["k"].dtype == torch.int8:
        return (
            dequantise_kv_rows(
                cache["k"][block_tables], cache["k_scale"][block_tables]
            ).reshape(shape),
            dequantise_kv_rows(
                cache["v"][block_tables], cache["v_scale"][block_tables]
            ).reshape(shape),
        )
    return (
        cache["k"][block_tables].reshape(shape),
        cache["v"][block_tables].reshape(shape),
    )


def _paged_kernel(cfg: ArchConfig, cache: dict, q, block_tables, pos, *,
                  local: bool, chunk: bool):
    """B1/B2 over model-dtype pages, B3/B4 over int8 pages."""
    kw = dict(
        window=cfg.sliding_window if local else None,
        softcap=cfg.attn_logit_softcap,
    )
    if cache["k"].dtype == torch.int8:
        fn = (kernels.paged_prefill_attention_int8 if chunk
              else kernels.paged_decode_attention_int8)
        return fn(q, cache["k"], cache["v"], cache["k_scale"],
                  cache["v_scale"], block_tables, pos, **kw)
    fn = kernels.paged_prefill_attention if chunk else kernels.paged_decode_attention
    return fn(q, cache["k"], cache["v"], block_tables, pos, **kw)


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
    then attends over the row's pages. An int8 pool quantises the row and
    writes its scales beside it; attention then follows the int8 dtype
    rule (module docstring).
    """
    ps = cache["k"].shape[1]
    pages_bucket = block_tables.shape[1]
    q, k, v = _qkv(cfg, p, x, pos[:, None])
    page_idx = (pos // ps).clamp(0, pages_bucket - 1).long()
    wpage = block_tables.gather(1, page_idx[:, None])[:, 0]
    _write_pages(cache, wpage, pos % ps, k[:, 0], v[:, 0])
    if attn_impl == "kernel":
        o = _paged_kernel(cfg, cache, q[:, 0], block_tables, pos,
                          local=local, chunk=False)
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
    """Chunk-of-C-tokens prompt ingestion through the paged KV cache (also
    the verify lane's window of K+1 rows).

    x: [B,C,D]; ``start``: i32[B] position of each row's first chunk token;
    ``length``: i32[B] real tokens (columns >= length are bucket padding).
    Writes all C K/V rows in place through the block table — page indices
    clipped to the bucket, padded columns redirected to the null page 0 —
    then attends causally: chunk row i sees positions <= start + i, which
    covers the cached prefix and the chunk's own rows. An int8 pool
    quantises the rows with the decode path's ``quantise_kv_rows``, so both
    write the same bits.
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
    _write_pages(cache, wpage, positions % ps, k, v)
    if attn_impl == "kernel":
        o = _paged_kernel(cfg, cache, q, block_tables, start,
                          local=local, chunk=True)
        return _out_proj(cfg, p, o), cache
    gk, gv = _gather_pages(cfg, cache, block_tables)
    return _decode_sdpa_rows(cfg, p, q, gk, gv, positions, local=local), cache


# ------------------------------------------------------- the draft's dense cache
def init_kv_cache(
    cfg: ArchConfig,
    batch: int,
    max_len: int,
    kv_dtype: str = "fp32",
    device: torch.device | str = "cpu",
) -> dict:
    """Dense per-slot KV cache ``[B, max_len, KH, dh]`` (the draft lanes'
    storage). ``kv_dtype="int8"`` stores int8 rows plus per-(row, position)
    f32 scales ``ks``/``vs`` of shape ``[B, max_len]``."""
    _check_kv_dtype(kv_dtype)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if kv_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(shape[:2], dtype=torch.float32, device=device),
            "vs": torch.zeros(shape[:2], dtype=torch.float32, device=device),
        }
    dt = dtype_of(cfg)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def _dense_view(cache: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole dense cache as keys/values: model dtype, or f32
    dequantised from int8 rows."""
    if cache["k"].dtype == torch.int8:
        return (
            dequantise_kv_rows(cache["k"], cache["ks"]),
            dequantise_kv_rows(cache["v"], cache["vs"]),
        )
    return cache["k"], cache["v"]


def decode_attention(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,
    cache: dict,
    pos: torch.Tensor,
    *,
    local: bool,
) -> tuple[torch.Tensor, dict]:
    """One-token decode into the dense per-slot cache, per-row form.

    x: [B,1,D]; cache k/v: [B,Smax,KH,dh]; ``pos``: i32[B], each row at its
    own depth. Writes row b's new K/V at ``pos[b]`` in place (a position
    past the cache writes nothing, as the JAX package's masked select) and
    attends with a per-row causal mask, so a slot that joined at position
    0 never sees its previous occupant's rows. An int8 cache quantises the
    row and follows the int8 dtype rule. The scalar-position form belongs
    to the burst engine (kernel B5) and is not ported.
    """
    if pos.dim() != 1:
        raise ValueError(
            "decode_attention takes per-row positions [B]; the scalar-"
            "position form belongs to the burst engine, which is not ported"
        )
    b = x.shape[0]
    smax = cache["k"].shape[1]
    q, k, v = _qkv(cfg, p, x, pos[:, None])
    rows = torch.arange(b, device=x.device)
    inside = pos < smax
    at = pos.clamp(max=smax - 1).long()

    def put(t: torch.Tensor, new: torch.Tensor) -> None:
        keep = inside.view(-1, *([1] * (new.dim() - 1)))
        t.index_put_((rows, at), torch.where(keep, new, t[rows, at]))

    if cache["k"].dtype == torch.int8:
        qk, ksc = quantise_kv_rows(k[:, 0])
        qv, vsc = quantise_kv_rows(v[:, 0])
        for name, new in (("k", qk), ("v", qv), ("ks", ksc), ("vs", vsc)):
            put(cache[name], new)
    else:
        put(cache["k"], k[:, 0])
        put(cache["v"], v[:, 0])
    ck, cv = _dense_view(cache)
    return _decode_sdpa_rows(cfg, p, q, ck, cv, pos, local=local), cache


def chunked_decode_attention(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,
    cache: dict,
    start: torch.Tensor,
    length: torch.Tensor,
    *,
    local: bool,
) -> tuple[torch.Tensor, dict]:
    """Chunk-of-C-tokens ingestion into the dense per-slot cache.

    x: [B,C,D]; ``start``: i32[B]; ``length``: i32[B] real tokens (0 = idle
    row, writes nothing). Cache row j of batch row b takes chunk row
    ``j - start`` when it lies in ``[start, start + length)`` (a masked
    select written back in place, as the JAX package's), then each chunk row
    attends causally at its own position. An int8 cache quantises the chunk
    once with ``quantise_kv_rows``: the same bits as C per-row decodes.
    """
    b, c = x.shape[:2]
    offs = torch.arange(c, dtype=torch.int32, device=x.device)
    positions = start[:, None] + offs[None, :]  # [B,C]
    q, k, v = _qkv(cfg, p, x, positions)
    ki = torch.arange(cache["k"].shape[1], device=x.device)
    sel = (ki[None, :] >= start[:, None]) & (
        ki[None, :] < (start + length)[:, None]
    )  # [B,Smax]
    idx = (ki[None, :] - start[:, None]).clamp(0, c - 1).long()  # [B,Smax]

    def insert(t: torch.Tensor, new: torch.Tensor) -> None:
        tail = new.shape[2:]
        at = idx.view(*idx.shape, *([1] * len(tail))).expand(*idx.shape, *tail)
        picked = torch.gather(new, 1, at)
        t.copy_(torch.where(sel.view(*sel.shape, *([1] * len(tail))), picked, t))

    if cache["k"].dtype == torch.int8:
        qk, ksc = quantise_kv_rows(k)
        qv, vsc = quantise_kv_rows(v)
        for name, new in (("k", qk), ("v", qv), ("ks", ksc), ("vs", vsc)):
            insert(cache[name], new)
    else:
        insert(cache["k"], k)
        insert(cache["v"], v)
    ck, cv = _dense_view(cache)
    return (
        _decode_sdpa_rows(cfg, p, q, ck, cv, positions, local=local),
        cache,
    )
