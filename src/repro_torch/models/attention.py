"""GQA attention: full-sequence (``forward``/``prefill``), through a paged
KV cache, and through the dense per-slot cache at a shared scalar position
(the burst engine) or at per-row positions (the speculative draft):
counterpart of ``repro.models.attention``.

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

Full-sequence attention (``attention``, ``prefill_attention``) has three
implementations, chosen semi-statically as ``impl`` when a step is built:
``"naive"`` (materialised ``[B,KH,G,S,S]`` scores, the JAX package's
baseline), ``"chunked"`` (online softmax over key blocks of ``perf``'s
``attn_block``, its flash-style data movement in plain PyTorch) and
``"kernel"`` (B6, ``kernels.flash_attention``; its plain version on the
CPU), fed ``[B,S,H,dh]`` activations as strided views. ``"auto"`` resolves
to ``perf.current().impl``, and ``"naive"``/``"chunked"`` read ``perf``'s
``score_dtype`` and ``probs_dtype`` where the JAX package does; the kernel
keeps both in f32 and refuses them (``perf.check_kernel_opts``).

The dense cache's decode (``decode_attention``) at a **scalar** position —
every row at one depth, the burst engine — writes the new K/V row at ``pos``
in place and attends with B5 (``attn_impl="kernel"``) or the JAX package's
einsum tail (``"plain"``); it takes model-dtype caches only, as the JAX
package's. At **per-row** positions (the dense continuous engine's ``cb``
lane and the draft's ``dr``) it, and ``chunked_decode_attention`` (the
``pfd``/``vfd`` lanes and the draft's ``drp``), write as the JAX package
does and attend through the paged kernels over ``dense_page_view``: a slot's
cache rows are a trivial identity block table (the JAX package's own words),
so ``[S, max_len, KH, dh]`` viewed as ``[S·max_len/ps, ps, KH, dh]`` is a
page pool and row s's table lists its own pages in order. B1 (B3 over int8
rows) serves the one-token form, B2 (B4) the chunk form; ``"plain"`` keeps
``_decode_sdpa_rows`` over the whole cache.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import kernels, perf
from repro_torch.configs import ArchConfig
from repro_torch.runtime.kvcache import KV_DTYPES

from .layers import apply_rope, dtype_of, rms_norm, softcap

NEG_INF = -2.0e38
ATTN_IMPLS = ("kernel", "plain")  # paged and dense decode
FULL_IMPLS = ("naive", "chunked", "kernel")  # forward and prefill ("auto": perf)
# int8 KV quantisation range (DESIGN.md §12): symmetric, full int8 span.
KV_QUANT_MAX = 127.0
KV_SCALE_EPS = 1e-8  # all-zero rows quantise with a tiny non-zero scale


def _dtype(name: str | None) -> torch.dtype | None:
    """A ``perf`` dtype name ("bfloat16") as a torch dtype (None stays)."""
    return None if name is None else getattr(torch, name)


def _qkv(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """x [B,S,D] -> q [B,S,H,dh], k/v [B,S,KH,dh], rope applied."""
    return (_q(cfg, p, x, positions), _k(cfg, p, x, positions),
            _v(cfg, p, x))


def _q(cfg: ArchConfig, p: dict, x: torch.Tensor,
       positions: torch.Tensor) -> torch.Tensor:
    """x [B,S,D] -> q [B,S,H,dh] at ``positions`` [B,S], rope applied."""
    b, s, d = x.shape
    q = (x @ p["wq"].reshape(d, -1)).view(b, s, cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_scale"], cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_theta)


def _k(cfg: ArchConfig, p: dict, x: torch.Tensor,
       positions: torch.Tensor) -> torch.Tensor:
    """x [B,S,D] -> k [B,S,KH,dh] at ``positions``, rope applied."""
    b, s, d = x.shape
    k = (x @ p["wk"].reshape(d, -1)).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_scale"], cfg.norm_eps)
    return apply_rope(k, positions, cfg.rope_theta)


def _v(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B,S,D] -> v [B,S,KH,dh]."""
    b, s, d = x.shape
    return (x @ p["wv"].reshape(d, -1)).view(b, s, cfg.num_kv_heads,
                                             cfg.head_dim)


def _out_proj(cfg: ArchConfig, p: dict, o: torch.Tensor) -> torch.Tensor:
    """o [B,S,H,dh] -> [B,S,D] through wo [H,dh,D]."""
    b, s = o.shape[:2]
    return o.reshape(b, s, cfg.q_dim) @ p["wo"].reshape(cfg.q_dim, -1)


def _group(cfg: ArchConfig, q: torch.Tensor) -> torch.Tensor:
    """[B,S,H,dh] -> [B,S,KH,G,dh]."""
    b, s, h, dh = q.shape
    return q.reshape(b, s, cfg.num_kv_heads, h // cfg.num_kv_heads, dh)


# ------------------------------------------------------- full sequence
def _mask(
    s_q: int,
    s_k: int,
    *,
    causal: bool,
    window: int | None,
    q_offset: int = 0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """[S_q, S_k] additive mask (0 / half the dtype's lowest value)."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    ki = torch.arange(s_k, device=device)[None, :]
    ok = torch.ones(s_q, s_k, dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    neg = torch.finfo(dtype).min / 2
    return torch.where(ok, 0.0, neg).to(dtype)


def _sdpa_naive(
    cfg: ArchConfig,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int | None,
    q_offset: int = 0,
) -> torch.Tensor:
    """q: [B,Sq,KH,G,dh]; k,v: [B,Sk,KH,dh] -> [B,Sq,KH,G,dh]; query ``i``
    sits at position ``q_offset + i`` (a shard's rows of a sequence split
    over the mesh). Scores are
    f32 products of the operands rounded once to ``perf``'s ``score_dtype``
    (the JAX package's ``preferred_element_type``), then scaled, capped,
    masked and softmaxed in that dtype one rounded op at a time, as
    ``jax.nn.softmax`` does; probabilities in ``probs_dtype``, else v's
    dtype."""
    po = perf.current()
    sd = _dtype(po.score_dtype) or torch.float32
    scale = torch.tensor(1.0 / np.sqrt(cfg.head_dim), dtype=sd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()).to(sd)
    scores = softcap(scores * scale, cfg.attn_logit_softcap)
    scores = scores + _mask(
        q.shape[1], k.shape[1], causal=True, window=window, dtype=sd,
        q_offset=q_offset, device=q.device,
    )
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = (e / e.sum(dim=-1, keepdim=True)).to(
        _dtype(po.probs_dtype) or v.dtype)
    return torch.einsum(
        "bhgqk,bkhd->bqhgd", probs, v.to(probs.dtype)
    ).to(v.dtype)


def _sdpa_chunked(
    cfg: ArchConfig,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int | None,
    block: int,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online softmax over key blocks: O(S·block) score memory instead of
    O(S²). Shapes and ``q_offset`` as ``_sdpa_naive``; the key length must
    be a multiple of the block (as in the JAX package). With ``perf``'s
    ``probs_dtype`` the P V product runs in that dtype."""
    b, sq, kh, g, dh = q.shape
    sk = k.shape[1]
    block = min(block, sk)
    if sk % block:
        raise ValueError(f"key length {sk} is not a multiple of block {block}")
    scale = 1.0 / np.sqrt(cfg.head_dim)
    pd = _dtype(perf.current().probs_dtype)
    qf = q.float()
    qi = torch.arange(sq, device=q.device)[:, None] + q_offset
    m = torch.full((b, kh, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, kh, g, sq), device=q.device)
    acc = torch.zeros((b, kh, g, sq, dh), device=q.device)
    for i in range(sk // block):
        k_i = k[:, i * block:(i + 1) * block].float()
        v_i = v[:, i * block:(i + 1) * block].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_i) * scale
        s = softcap(s, cfg.attn_logit_softcap)
        ki = torch.arange(block, device=q.device)[None, :] + i * block
        ok = ki <= qi
        if window is not None:
            ok &= ki > qi - window
        s = s + torch.where(ok, 0.0, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p_ = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p_.sum(dim=-1)
        if pd is not None:
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p_.to(pd), v_i.to(pd)).float()
        else:
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p_, v_i)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-37)[..., None]
    return out.movedim(-2, 1).to(v.dtype)  # [B,Sq,KH,G,dh]


def _full_sequence(
    cfg: ArchConfig, p: dict, q, k, v, *, local: bool, impl: str
) -> torch.Tensor:
    """Causal self-attention of q [B,S,H,dh] over k/v [B,S,KH,dh], projected
    through ``wo`` -> [B,S,D], by the semi-static ``impl`` (``"auto"``:
    ``perf``'s)."""
    window = cfg.sliding_window if local else None
    b, s = q.shape[:2]
    po = perf.current()
    if impl == "auto":
        impl = po.impl
    if impl == "kernel":
        perf.check_kernel_opts("impl='kernel'", po)
        o = kernels.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=window, softcap=cfg.attn_logit_softcap,
        ).transpose(1, 2)  # [B,S,H,dh]: the kernel writes q's layout
        return _out_proj(cfg, p, o)
    if impl == "chunked":
        og = _sdpa_chunked(cfg, _group(cfg, q), k, v, window=window,
                           block=po.attn_block)
    elif impl == "naive":
        og = _sdpa_naive(cfg, _group(cfg, q), k, v, window=window)
    else:
        raise ValueError(f"impl must be one of {FULL_IMPLS}, got {impl!r}")
    return _out_proj(cfg, p, og.reshape(b, s, cfg.num_heads, cfg.head_dim))


def attention(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    local: bool,
    impl: str = "kernel",
) -> torch.Tensor:
    """Full-sequence causal attention. x: [B,S,D] -> [B,S,D]."""
    q, k, v = _qkv(cfg, p, x, positions)
    return _full_sequence(cfg, p, q, k, v, local=local, impl=impl)


def prefill_attention(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    local: bool,
    impl: str = "kernel",
) -> tuple[torch.Tensor, dict]:
    """Full-sequence attention that also returns the populated KV cache
    ``{"k", "v"}`` of ``[B,S,KH,dh]``."""
    q, k, v = _qkv(cfg, p, x, positions)
    out = _full_sequence(cfg, p, q, k, v, local=local, impl=impl)
    return out, {"k": k, "v": v}


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
    return _out_proj(cfg, p, _decode_sdpa_core(cfg, q, keys, vals, pos,
                                               local=local))


def _decode_sdpa_core(
    cfg: ArchConfig,
    q: torch.Tensor,
    keys: torch.Tensor,
    vals: torch.Tensor,
    pos: torch.Tensor,
    *,
    local: bool,
) -> torch.Tensor:
    """``_decode_sdpa_rows`` before ``wo``: the attention output
    [B,Sq,H,dh].

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
    return og.reshape(b, sq, cfg.num_heads, cfg.head_dim)


def kv_row_amax(x: torch.Tensor) -> torch.Tensor:
    """The absmax of each token row of ``x [..., KH, dh]`` in f32 ->
    ``[...]``: what ``quantise_kv_rows`` scales by."""
    return x.float().abs().amax(dim=(-2, -1))


def quantise_kv_rows(x: torch.Tensor, amax: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token-row symmetric int8 quantisation (DESIGN.md §12).

    ``x``: ``[..., KH, dh]`` K or V rows. Each row (one token's heads × dims)
    gets its own absmax scale ``max(amax / 127, 1e-8)`` in f32, then
    ``round`` (half to even, as ``jnp.round``) and ``clip`` to ±127. Returns
    ``(q int8[..., KH, dh], scale f32[...])``: the same bits as the JAX
    package's ``quantise_kv_rows``. One implementation for every lane's
    write, so chunked and token-by-token ingestion write the same bits.
    ``amax`` (``[...]``) replaces the rows' own absmax: a shard holding
    some of a row's heads passes the maximum over all of them
    (``models.tensor_parallel``), so it writes the whole row's bits."""
    xf = x.float()
    if amax is None:
        amax = kv_row_amax(xf)
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


def _write_pages(cache: dict, wpage, woff, k: torch.Tensor, v: torch.Tensor,
                 amax: tuple | None = None):
    """In-place write of K/V rows at ``pages[wpage, woff]`` (quantised with
    their scales for an int8 pool; ``amax`` = the K and V rows' absmax where
    the caller holds only some of their heads)."""
    if cache["k"].dtype == torch.int8:
        ka, va = amax or (None, None)
        qk, ksc = quantise_kv_rows(k, ka)
        qv, vsc = quantise_kv_rows(v, va)
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
    q, k, v = _qkv(cfg, p, x, pos[:, None])
    o = paged_decode_core(cfg, cache, q, k, v, pos, block_tables,
                          local=local, attn_impl=attn_impl)
    return _out_proj(cfg, p, o), cache


def paged_decode_core(
    cfg: ArchConfig,
    cache: dict,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    local: bool,
    attn_impl: str = "kernel",
    amax: tuple | None = None,
) -> torch.Tensor:
    """``paged_decode_attention`` between the projections: write the new
    K/V row (k/v [B,1,KH,dh]) and attend q [B,1,H,dh] over the row's pages
    -> [B,1,H,dh] (the tensor-parallel forward runs it on each shard's
    heads; ``amax`` as ``_write_pages``, [B,1] each)."""
    ps = cache["k"].shape[1]
    pages_bucket = block_tables.shape[1]
    page_idx = (pos // ps).clamp(0, pages_bucket - 1).long()
    wpage = block_tables.gather(1, page_idx[:, None])[:, 0]
    _write_pages(cache, wpage, pos % ps, k[:, 0], v[:, 0],
                 amax and (amax[0][:, 0], amax[1][:, 0]))
    if attn_impl == "kernel":
        o = _paged_kernel(cfg, cache, q[:, 0], block_tables, pos,
                          local=local, chunk=False)
        return o[:, None]
    gk, gv = _gather_pages(cfg, cache, block_tables)
    return _decode_sdpa_core(cfg, q, gk, gv, pos, local=local)


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
    q, k, v = _qkv(cfg, p, x, chunk_positions(start, x.shape[1]))
    o = paged_prefill_core(cfg, cache, q, k, v, start, block_tables, length,
                           local=local, attn_impl=attn_impl)
    return _out_proj(cfg, p, o), cache


def chunk_positions(start: torch.Tensor, c: int) -> torch.Tensor:
    """The positions [B,C] of a chunk of ``c`` rows starting at ``start``."""
    offs = torch.arange(c, dtype=torch.int32, device=start.device)
    return start[:, None] + offs[None, :]


def paged_prefill_core(
    cfg: ArchConfig,
    cache: dict,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    start: torch.Tensor,
    block_tables: torch.Tensor,
    length: torch.Tensor,
    *,
    local: bool,
    attn_impl: str = "kernel",
    amax: tuple | None = None,
) -> torch.Tensor:
    """``paged_prefill_attention`` between the projections: write the
    chunk's K/V rows (k/v [B,C,KH,dh]; padded columns to the null page)
    and attend q [B,C,H,dh] causally -> [B,C,H,dh] (``amax`` as
    ``_write_pages``, [B,C] each)."""
    c = q.shape[1]
    ps = cache["k"].shape[1]
    pages_bucket = block_tables.shape[1]
    offs = torch.arange(c, dtype=torch.int32, device=q.device)
    positions = start[:, None] + offs[None, :]  # [B,C]
    page_idx = (positions // ps).clamp(0, pages_bucket - 1).long()
    wpage = block_tables.gather(1, page_idx)  # [B,C]
    wpage = torch.where(offs[None, :] < length[:, None], wpage, 0)
    _write_pages(cache, wpage, positions % ps, k, v, amax)
    if attn_impl == "kernel":
        return _paged_kernel(cfg, cache, q, block_tables, start,
                             local=local, chunk=True)
    gk, gv = _gather_pages(cfg, cache, block_tables)
    return _decode_sdpa_core(cfg, q, gk, gv, positions, local=local)


# ------------------------------------------------------- the dense per-slot cache
def init_kv_cache(
    cfg: ArchConfig,
    batch: int,
    max_len: int,
    kv_dtype: str = "fp32",
    device: torch.device | str = "cpu",
) -> dict:
    """Dense per-slot KV cache ``[B, max_len, KH, dh]`` (the dense
    continuous engine's and the draft lanes' storage). ``kv_dtype="int8"``
    stores int8 rows plus per-(row, position) f32 scales ``ks``/``vs`` of
    shape ``[B, max_len]``."""
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


def dense_page_size(max_len: int) -> int:
    """The page size of a dense cache's page view: 16 where ``max_len`` is a
    multiple of 16, else 8 — the two sizes B1-B4 are instantiated at
    (``kernels.build.PAGE_SIZES``). Any other ``max_len`` has no view and
    raises ``ValueError``."""
    for ps in (16, 8):
        if max_len % ps == 0:
            return ps
    raise ValueError(
        f"a dense KV cache of max_len={max_len} has no page view: the paged "
        f"kernels take pages of 16 or 8 rows, so max_len must be a multiple "
        f"of 8"
    )


def dense_rows(max_len: int) -> int:
    """The rows an engine allocates a dense cache of ``max_len`` positions
    with: ``max_len`` rounded up to a multiple of 8, so that
    ``dense_page_view`` exists for every ``max_len``. Admission still holds
    each request to ``max_len`` positions (prompt, tokens and any verify
    window), so no kept output reads a row past it: a query at position p
    sees rows <= p only. What lands there — the draft's writes past a
    request's end, a finished slot's idle step — is never read by a kept
    output, as the JAX package's cache of exactly ``max_len`` rows drops
    such writes."""
    return -(-max_len // 8) * 8


def dense_page_view(cache: dict) -> tuple[dict, torch.Tensor]:
    """One layer's dense cache as a page pool, for the paged kernels.

    ``k``/``v`` ``[S, max_len, KH, dh]`` become ``[S·max_len/ps, ps, KH,
    dh]`` and int8 scales ``ks``/``vs`` ``[S, max_len]`` become the pool's
    ``k_scale``/``v_scale`` ``[S·max_len/ps, ps]``, all views of the same
    memory (page size from ``dense_page_size``). Returns ``(pool,
    table)``: the identity block table ``i32[S, max_len/ps]`` whose row s
    is ``s·max_len/ps + arange(max_len/ps)``. The kernels clamp a row's
    page range to its table, so a position at or past ``max_len`` attends
    over every row of the slot, as the dense mask does."""
    s, smax = cache["k"].shape[:2]
    ps = dense_page_size(smax)
    pages = s * (smax // ps)
    tail = cache["k"].shape[2:]
    pool = {"k": cache["k"].view(pages, ps, *tail),
            "v": cache["v"].view(pages, ps, *tail)}
    if "ks" in cache:
        pool["k_scale"] = cache["ks"].view(pages, ps)
        pool["v_scale"] = cache["vs"].view(pages, ps)
    table = torch.arange(pages, dtype=torch.int32, device=cache["k"].device)
    return pool, table.view(s, smax // ps)


def _dense_view(cache: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole dense cache as keys/values: model dtype, or f32
    dequantised from int8 rows."""
    if cache["k"].dtype == torch.int8:
        return (
            dequantise_kv_rows(cache["k"], cache["ks"]),
            dequantise_kv_rows(cache["v"], cache["vs"]),
        )
    return cache["k"], cache["v"]


def _decode_at_scalar(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,
    cache: dict,
    pos: torch.Tensor,
    *,
    local: bool,
    attn_impl: str,
) -> tuple[torch.Tensor, dict]:
    """The burst engine's decode: every row at the 0-dim position ``pos``.
    The new K/V row lands at ``pos`` (clamped into the cache, as the JAX
    package's ``dynamic_update_slice``) by ``index_copy_`` on the device
    tensor, so no step waits for the host; then B5 or the plain tail."""
    b = x.shape[0]
    smax = cache["k"].shape[1]
    q, k, v = _qkv(cfg, p, x, pos.reshape(1, 1).expand(b, 1))
    at = pos.clamp(0, smax - 1).reshape(1).long()
    cache["k"].index_copy_(1, at, k)
    cache["v"].index_copy_(1, at, v)
    if attn_impl == "kernel":
        o = kernels.decode_attention(
            q[:, 0], cache["k"].transpose(1, 2), cache["v"].transpose(1, 2),
            pos, window=cfg.sliding_window if local else None,
            softcap=cfg.attn_logit_softcap,
        )
        return _out_proj(cfg, p, o[:, None]), cache
    return _decode_sdpa_rows(
        cfg, p, q, cache["k"], cache["v"], pos.expand(b), local=local
    ), cache


def decode_attention(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,
    cache: dict,
    pos: torch.Tensor,
    *,
    local: bool,
    attn_impl: str = "kernel",
) -> tuple[torch.Tensor, dict]:
    """One-token decode into the dense per-slot cache.

    x: [B,1,D]; cache k/v: [B,Smax,KH,dh]. ``pos`` is either a 0-dim i32
    tensor — the whole batch at one position, the burst engine; model-dtype
    caches only, attention by ``attn_impl`` (B5 or plain) — or i32[B], each
    row at its own depth (the ``cb`` and ``dr`` lanes). The per-row form
    writes row b's new K/V at ``pos[b]`` in place (a position past the
    cache writes nothing, as the JAX package's masked select) and attends
    with a per-row causal mask — B1 (B3 on an int8 cache) over
    ``dense_page_view`` with ``"kernel"``, ``_decode_sdpa_rows`` with
    ``"plain"`` — so a slot that joined at position 0 never sees its
    previous occupant's rows; an int8 cache quantises the row and follows
    the int8 dtype rule.
    """
    if pos.dim() == 0:
        if cache["k"].dtype == torch.int8:
            raise ValueError("int8 dense KV caches require per-row pos [B]")
        return _decode_at_scalar(
            cfg, p, x, cache, pos, local=local, attn_impl=attn_impl
        )
    q, k, v = _qkv(cfg, p, x, pos[:, None])
    o = dense_decode_core(cfg, cache, q, k, v, pos, local=local,
                          attn_impl=attn_impl)
    return _out_proj(cfg, p, o), cache


def _put_rows(cache: dict, rows, at, keep, k: torch.Tensor, v: torch.Tensor,
              amax: tuple | None) -> None:
    """Write K/V rows (and an int8 cache's scales) at ``[rows, at]`` of a
    dense cache where ``keep``; elsewhere the old value is put back."""

    def put(t: torch.Tensor, new: torch.Tensor) -> None:
        k_ = keep.view(*keep.shape, *([1] * (new.dim() - keep.dim())))
        t.index_put_((rows, at), torch.where(k_, new, t[rows, at]))

    if cache["k"].dtype == torch.int8:
        ka, va = amax or (None, None)
        qk, ksc = quantise_kv_rows(k, ka)
        qv, vsc = quantise_kv_rows(v, va)
        for name, new in (("k", qk), ("v", qv), ("ks", ksc), ("vs", vsc)):
            put(cache[name], new)
    else:
        put(cache["k"], k)
        put(cache["v"], v)


def dense_decode_core(
    cfg: ArchConfig,
    cache: dict,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: torch.Tensor,
    *,
    local: bool,
    attn_impl: str = "kernel",
    amax: tuple | None = None,
) -> torch.Tensor:
    """``decode_attention`` at per-row positions between the projections:
    write row b's new K/V (k/v [B,1,KH,dh]) at ``pos[b]`` (nothing past the
    cache) and attend q [B,1,H,dh] -> [B,1,H,dh] (the tensor-parallel
    forward runs it on each shard's heads; ``amax`` as ``_write_pages``,
    [B,1] each)."""
    b = q.shape[0]
    smax = cache["k"].shape[1]
    rows = torch.arange(b, device=q.device)
    _put_rows(cache, rows, pos.clamp(max=smax - 1).long(), pos < smax,
              k[:, 0], v[:, 0], amax and (amax[0][:, 0], amax[1][:, 0]))
    if attn_impl == "kernel":
        pool, table = dense_page_view(cache)
        o = _paged_kernel(cfg, pool, q[:, 0], table, pos, local=local,
                          chunk=False)
        return o[:, None]
    ck, cv = _dense_view(cache)
    return _decode_sdpa_core(cfg, q, ck, cv, pos, local=local)


def chunked_decode_attention(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,
    cache: dict,
    start: torch.Tensor,
    length: torch.Tensor,
    *,
    local: bool,
    attn_impl: str = "kernel",
) -> tuple[torch.Tensor, dict]:
    """Chunk-of-C-tokens ingestion into the dense per-slot cache (the
    ``pfd`` and ``vfd`` lanes, the draft's ``drp``).

    x: [B,C,D]; ``start``: i32[B]; ``length``: i32[B] real tokens (0 = idle
    row, writes nothing). Chunk row i of batch row b lands at cache row
    ``start[b] + i`` when ``i < length[b]`` and that row lies inside the
    cache — the rows the JAX package's masked select writes, and the same
    bits — by one scatter of the B·C rows, not a pass over the whole cache.
    A row that writes nothing puts its old value back at ``(start[b] + i) %
    max_len``: the C targets of a batch row are then distinct (C <=
    max_len), so no two writes race. Each chunk row then attends causally
    at its own position: B2 (B4 on an int8 cache) over ``dense_page_view``
    with ``"kernel"``, ``_decode_sdpa_rows`` with ``"plain"``. An int8
    cache quantises the chunk once with ``quantise_kv_rows``: the same
    bits as C per-row decodes.
    """
    c = x.shape[1]
    smax = cache["k"].shape[1]
    if c > smax:
        raise ValueError(
            f"a chunk of {c} rows does not fit a dense cache of max_len={smax}"
        )
    q, k, v = _qkv(cfg, p, x, chunk_positions(start, c))
    o = dense_chunk_core(cfg, cache, q, k, v, start, length, local=local,
                         attn_impl=attn_impl)
    return _out_proj(cfg, p, o), cache


def dense_chunk_core(
    cfg: ArchConfig,
    cache: dict,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    start: torch.Tensor,
    length: torch.Tensor,
    *,
    local: bool,
    attn_impl: str = "kernel",
    amax: tuple | None = None,
) -> torch.Tensor:
    """``chunked_decode_attention`` between the projections: write the
    chunk's K/V rows (k/v [B,C,KH,dh]) and attend q [B,C,H,dh] causally ->
    [B,C,H,dh] (``amax`` as ``_write_pages``, [B,C] each)."""
    b, c = q.shape[:2]
    smax = cache["k"].shape[1]
    positions = chunk_positions(start, c)  # [B,C]
    offs = positions - start[:, None]
    keep = (offs < length[:, None]) & (positions < smax)  # [B,C]
    rows = torch.arange(b, device=q.device)[:, None].expand(b, c)
    _put_rows(cache, rows, (positions % smax).long(), keep, k, v, amax)
    if attn_impl == "kernel":
        pool, table = dense_page_view(cache)
        return _paged_kernel(cfg, pool, q, table, start, local=local,
                             chunk=True)
    ck, cv = _dense_view(cache)
    return _decode_sdpa_core(cfg, q, ck, cv, positions, local=local)
