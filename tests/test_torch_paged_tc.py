"""The tensor-core body of kernels B2 and B4 (paged prefill/verify attention,
bf16 at head_dim 64 and 128, ``csrc/paged_prefill_tc.cuh``).

On the CPU: an emulation of the body's arithmetic (bf16 q and K, int8 pages
widened exactly, the K scale on S's columns, the V scale folded into P
before P's bf16 rounding (relative to the scale of each row's leading key,
which multiplies O's row), an unscaled denominator, 64- or 128-key tiles over
a ragged page table with the kernel's loop bounds and clamped edge pages)
against the fp32 plain versions, within the card's bf16 tolerance; the C
entry points' routing by dtype and head_dim; the wrapper's TMA alignment
check; the same emulation at the full-width GQA groups 6 (Q over the
16-byte path, softcap 30) and 8 (Q by TMA). On a card (marked ``cuda``,
skipped here): the kernels against their plain versions over chunks 1-130,
GQA groups 1, 5 and 16 (and 6 and 8 at chunks 1, 64 and 130), pages of 8
and 16 and every mode, and the wrapper's refusal of a misaligned view.

Inputs come from a numpy seed. The JAX package is not needed: the plain
versions are held against the Pallas kernels in ``test_torch_kernels.py``.
"""

from __future__ import annotations

import math
import re

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import NEG_INF
from repro_torch.kernels.prefill_attention import _check_tma_operands
from repro_torch.models import quantise_kv_rows
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

# chip_smoke.py's KERNEL_ATOL[bf16], the kernels' tolerance on the card
BF16_KERNEL_ATOL = 2e-2
MODES = [(None, None), (40, None), (None, 30.0), (40, 30.0)]  # window, cap
LOG2E = 1.4426950408889634


def _pools(ps: int, kh: int, dh: int, n_pages: int, seed: int):
    """fp32 pages, their bf16 pool and their int8 (pages, scales) pool."""
    rng = np.random.default_rng(seed)
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (n_pages, ps, kh, dh)).astype(np.float32)) for _ in range(2))
    return (kp.bfloat16(), vp.bfloat16()), (quantise_kv_rows(kp),
                                            quantise_kv_rows(vp))


def _tc_rounding(q, k_pages, v_pages, bt, start, *, window, softcap, tile,
                 k_scale=None, v_scale=None):
    """The tensor-core body's arithmetic in PyTorch over the packed rows
    of each (row, kv head) — a query head's rows see its kv head's keys,
    so a GQA group only packs more rows into the tile: raw page values (int8 exact in
    bf16), S = q k in fp32 times the K scale of each column, the softcap,
    key tiles from the first row's window to the last row's frontier with
    pages outside [p_lo, p_hi] clamped in and masked, exp2 of logits scaled
    by log2 e, P times the V scale over the scale of the row's leading key
    (S; 1 where that key's row was never written, scale 0) rounded to bf16
    for P V with fp32 accumulation, O's row times S, the denominator summed
    from the unscaled P, the output rounded to bf16. The hardware's
    approximate exp2 and tanh are left to the card's checks."""
    b, c, h, dh = q.shape
    _, ps, kh, _ = k_pages.shape
    pb = bt.shape[1]
    quant = k_scale is not None
    out = torch.empty(b, c, h, dh)
    for row in range(b):
        st = int(start[row])
        qi = st + torch.arange(c)
        p_hi = min((st + c - 1) // ps, pb - 1)
        p_lo = max(st - window + 1, 0) // ps if window is not None else 0
        key_end = (p_hi + 1) * ps - 1
        qr = q[row].float().permute(1, 0, 2)  # [H, C, dh]
        m = torch.full((h, c), NEG_INF)
        l = torch.zeros(h, c)
        o = torch.zeros(h, c, dh)
        for k0 in range(p_lo * ps // tile * tile, p_hi * ps + 1, tile):
            ki = torch.arange(k0, k0 + tile)
            lp = (ki // ps).clamp(p_lo, p_hi)  # logical pages, edges clamped
            page, off = bt[row, lp].long(), ki % ps
            kt, vt = (p_[page, off].float().permute(1, 0, 2)  # [KH, T, dh]
                      .repeat_interleave(h // kh, 0) for p_ in (k_pages,
                                                                v_pages))
            s = torch.einsum("hqd,hkd->hqk", qr, kt) * (1.0 / math.sqrt(dh))
            if quant:
                s = s * k_scale[page, off]
            if softcap is not None:
                s = torch.tanh(s / softcap) * softcap
            ok = ki[None, :] <= qi.clamp_max(key_end)[:, None]
            if window is not None:
                ok &= ki[None, :] > (qi - window)[:, None]
            x = torch.where(ok, s * LOG2E, NEG_INF)
            m_new = torch.maximum(m, x.amax(-1))
            p = torch.exp2(x - m_new[..., None])
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(-1)
            if quant:  # V scales relative to each row's leading key's
                vsc = v_scale[page, off]
                lead = vsc[x.argmax(-1)]
                lead = torch.where(lead == 0, 1.0, lead)
                pv = p * vsc / lead[..., None]
            else:
                lead, pv = torch.ones_like(m), p
            o = (o * (corr / lead)[..., None] + torch.einsum(
                "hqk,hkd->hqd", pv.bfloat16().float(), vt)) * lead[..., None]
            m = m_new
        out[row] = (o / l.clamp_min(1e-37)[..., None]).permute(1, 0, 2)
    return out.bfloat16()


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("window,softcap", MODES)
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_tensor_core_rounding_stays_within_the_bf16_tolerance(
    pages, window, softcap, tile, dh
):
    """P rounded to bf16 (after the V scale, for int8) is the one rounding
    the body adds; at 64 chunk rows, 16 heads of 64 or 128 (both
    instantiations), starts off page boundaries and a ragged table it keeps
    the output within the card's bf16 tolerance of the fp32 plain
    version."""
    _rounding_case(pages, window, softcap, tile, dh, kh=16, group=1)


@pytest.mark.parametrize("group,window,softcap", [(6, None, 30.0),
                                                  (8, 40, None)])
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_tensor_core_rounding_at_full_width_groups(pages, group, window,
                                                   softcap):
    """Groups 6 (grok-1-314b, softcap 30: Q over the 16-byte path, since a
    tile's 64 rows are no whole number of groups of 6) and 8
    (deepseek-67b and jamba: Q by TMA) at dh 128, 2 kv heads: within the
    card's bf16 tolerance."""
    _rounding_case(pages, window, softcap, 64, 128, kh=2, group=group)


def _rounding_case(pages, window, softcap, tile, dh, *, kh, group):
    ps, c = 16, 64
    (kb, vb), ((kq, ks), (vq, vs)) = _pools(ps, kh, dh, 16, seed=3)
    bt = torch.tensor([[3, 9, 1, 12, 5, 0, 0, 0],
                       [7, 2, 8, 4, 11, 6, 14, 0]], dtype=torch.int32)
    start = torch.tensor([5, 37], dtype=torch.int32)
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, c, kh * group, dh)).astype(
        np.float32)).bfloat16()
    kw = dict(window=window, softcap=softcap)
    if pages == "bf16":
        emulated = _tc_rounding(q, kb, vb, bt, start, tile=tile, **kw)
        plain = kernels.paged_prefill_attention_plain(
            q.float(), kb.float(), vb.float(), bt, start, **kw)
    else:
        emulated = _tc_rounding(q, kq, vq, bt, start, tile=tile, k_scale=ks,
                                v_scale=vs, **kw)
        plain = kernels.paged_prefill_attention_int8_plain(
            q.float(), kq, vq, ks, vs, bt, start, **kw)
    err = (emulated.float() - plain).abs().max().item()
    assert 0 < err <= BF16_KERNEL_ATOL


def _unwritten_lead_case():
    """An int8 pool whose written keys all score below 0 against q, and a
    last page whose rows past the frontier were never written (K and V 0,
    scales 0, as a zeroed pool holds them): the chunk's later rows see them
    causally, and a never-written key leads their tile (score 0)."""
    ps, c, kh, dh = 16, 64, 2, 128
    _, ((kq, ks), (vq, vs)) = _pools(ps, kh, dh, 8, seed=6)
    kq = -kq.abs()  # every written key scores below 0 against q > 0
    bt = torch.tensor([[3, 5, 0, 0]], dtype=torch.int32)
    start = torch.tensor([0], dtype=torch.int32)
    for t in (kq, vq, ks, vs):  # page 5's rows 8.. never written
        t[5, 8:] = 0
    q = torch.ones(1, c, kh, dh).bfloat16()
    return q, (kq, vq, ks, vs), bt, start


def test_tensor_core_rounding_with_a_never_written_row_leading():
    """Where a never-written row (scale 0) leads a query row's tile, the V
    scales fold bare (a reciprocal of 0 would make the row NaN, and its
    K/V, written to the null page, every later read of it): finite and
    within the bf16 tolerance of the plain version."""
    q, (kq, vq, ks, vs), bt, start = _unwritten_lead_case()
    emulated = _tc_rounding(q, kq, vq, bt, start, tile=64, window=None,
                            softcap=None, k_scale=ks, v_scale=vs)
    plain = kernels.paged_prefill_attention_int8_plain(
        q.float(), kq, vq, ks, vs, bt, start)
    assert torch.isfinite(emulated.float()).all()
    assert (emulated.float() - plain).abs().max().item() <= BF16_KERNEL_ATOL


def _entry_routes(src: str, entry: str) -> dict:
    """{(dtype code, head_dim): launcher} of one C entry point."""
    body = src.split(f'extern "C" int {entry}(')[1].split("\n}\n")[0]
    return {(int(d), int(hd)): fn for d, hd, fn in re.findall(
        r"if \(dtype == (\d) && head_dim == (\d+)\) return (\w+)", body)}


@pytest.mark.parametrize("source,entry", [
    ("paged_attention.cu", "paged_prefill_attention"),
    ("paged_attention_int8.cu", "paged_prefill_attention_int8"),
])
def test_prefill_entry_points_route_bf16_128_to_tensor_cores(source, entry):
    """Both C entry points send bf16 (code 1) at head_dim 64 and 128 to the
    tensor-core body and fp32 or head_dim 16 to the CUDA-core body, for
    every dtype and head_dim the wrappers accept."""
    src = (build.CSRC / source).read_text()
    assert '#include "paged_prefill_tc.cuh"' in src
    routes = _entry_routes(src, entry)
    assert set(routes) == build.instantiated()
    assert {(1, 64), (1, 128)} <= set(routes)
    for key, fn in routes.items():
        want = ("launch_prefill_tensor_cores" if key in ((1, 64), (1, 128))
                else "launch_prefill_cuda_cores")
        assert fn == want, (key, fn)


def test_tensor_core_body_runs_wgmma_over_a_tma_ring():
    """The body computes Q Kᵀ and P V by wgmma and brings pages in by TMA
    into an mbarrier ring; it never falls back to the CUDA-core body."""
    src = (build.CSRC / "paged_prefill_tc.cuh").read_text()
    assert "paged_prefill_tc.cuh" in build.HEADERS
    body = src.split("paged_prefill_tc_kernel(")[1].split("\n}\n")[0]
    for call in ("wgmma_ss(", "wgmma_rs(", "mbar_wait(", "tma_load_4d(",
                 "mbar_expect_tx(", "mbar_arrive(empty"):
        assert call in body, call
    assert "attend_pages" not in body and "paged_prefill_kernel" not in body
    assert re.search(r"constexpr int kStages = ([2-9])", src)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values, contiguous, at a base one element past 16-byte
    alignment."""
    flat = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = flat[1 : 1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("dh", [64, 128])
def test_tma_check_refuses_what_tma_cannot_load(dh):
    """bf16 at dh 64 and 128 (the tensor-core body) needs 16-byte aligned
    q, pages and scales; fp32 and head_dim 16 (CUDA cores) do not."""
    (kb, vb), ((kq, ks), (vq, vs)) = _pools(16, 2, dh, 5, seed=1)
    q = torch.zeros(2, 5, 2, dh, dtype=torch.bfloat16)
    _check_tma_operands("prefill", q, kb, vb)  # fresh tensors pass
    _check_tma_operands("prefill_int8", q, kq, vq, ks, vs)
    with pytest.raises(ValueError, match="cannot be loaded by TMA"):
        _check_tma_operands("prefill", _misaligned(q), kb, vb)
    with pytest.raises(ValueError, match="cannot be loaded by TMA"):
        _check_tma_operands("prefill", q, kb, _misaligned(vb))
    with pytest.raises(ValueError, match="cannot be loaded by TMA"):
        _check_tma_operands("prefill_int8", q, _misaligned(kq), vq, ks, vs)
    with pytest.raises(ValueError, match="cannot be loaded by TMA"):
        _check_tma_operands("prefill_int8", q, kq, vq, ks, _misaligned(vs))
    _check_tma_operands("prefill", _misaligned(q.float()), kb.float(),
                        vb.float())  # fp32: CUDA cores
    _check_tma_operands("prefill", _misaligned(q[..., :16].contiguous()),
                        kb[..., :16], vb[..., :16])  # head_dim 16


# ------------------------------------------------------------- on the card
CHUNKS = (1, 5, 63, 64, 65, 130)
GROUPS = (1, 5, 16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(chunk, group, ps, device, seed, dh=128):
    """2 kv heads of ``dh``, 3 rows at starts off page boundaries, each
    row's pages scattered over the pool, the table padded with the null
    page 0."""
    kh = 2
    start = [5, ps + 3, 3 * ps - 1]
    pb = -(-(max(start) + chunk) // ps) + 1
    n_pages = 3 * pb + 1
    rng = np.random.default_rng(seed)
    bt = (rng.permutation(n_pages - 1)[: 3 * pb] + 1).reshape(3, pb)
    for r, s in enumerate(start):
        bt[r, -(-(s + chunk) // ps):] = 0
    (kb, vb), ((kq, ks), (vq, vs)) = _pools(ps, kh, dh, n_pages, seed)
    q = torch.from_numpy(rng.standard_normal(
        (3, chunk, kh * group, dh)).astype(np.float32)).bfloat16()
    to = lambda *ts: [t.to(device) for t in ts]  # noqa: E731
    return (*to(q, torch.from_numpy(bt).int(), torch.tensor(start).int()),
            to(kb, vb), to(kq, vq, ks, vs))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_cuda_tensor_core_prefill_matches_plain(cuda, chunk, group, ps, dh):
    """B2 and B4 in bf16 at dh 64 and 128 in every mode (a window of 40
    crossing page boundaries, softcap 30) within 2e-2 of the fp32 plain
    version: the kernel rounds P and its output to bf16."""
    q, bt, st, (kb, vb), (kq, vq, ks, vs) = _card_inputs(
        chunk, group, ps, cuda, seed=chunk * 31 + group * 7 + ps, dh=dh)
    for window, softcap in MODES:
        kw = dict(window=window, softcap=softcap)
        for kernel, args, plain in (
            (kernels.paged_prefill_attention, (kb, vb),
             kernels.paged_prefill_attention_plain),
            (kernels.paged_prefill_attention_int8, (kq, vq, ks, vs),
             kernels.paged_prefill_attention_int8_plain),
        ):
            before = kernel.launches
            out = kernel(q, *args, bt, st, **kw)
            ref_args = args if len(args) == 4 else [a.float() for a in args]
            ref = plain(q.float(), *ref_args, bt, st, **kw)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            torch.testing.assert_close(out.float(), ref,
                                       atol=BF16_KERNEL_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("group", [6, 8])
@pytest.mark.parametrize("chunk", [1, 64, 130])
def test_cuda_tensor_core_prefill_matches_plain_at_full_width_groups(
    cuda, chunk, group, dh
):
    """Groups 6 (the 16-byte Q path) and 8 (Q by TMA) at pages of 16,
    every mode, as ``test_cuda_tensor_core_prefill_matches_plain``."""
    test_cuda_tensor_core_prefill_matches_plain(cuda, chunk, group, 16, dh)


@pytest.mark.cuda
def test_cuda_int8_never_written_row_leading_stays_finite(cuda):
    """B4 where a never-written row (scale 0) leads a tile: finite, within
    2e-2 of the plain version (``_unwritten_lead_case``)."""
    q, pools, bt, start = _unwritten_lead_case()
    args = [t.to(cuda) for t in (q, *pools, bt, start)]
    out = kernels.paged_prefill_attention_int8(*args)
    ref = kernels.paged_prefill_attention_int8_plain(args[0].float(),
                                                     *args[1:])
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref, atol=BF16_KERNEL_ATOL,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_prefill_wrapper_raises_on_a_misaligned_bf16_view(cuda, int8,
                                                               dh):
    q, bt, st, (kb, vb), (kq, vq, ks, vs) = _card_inputs(5, 1, 16, cuda, 0,
                                                         dh=dh)
    kernel = (kernels.paged_prefill_attention_int8 if int8
              else kernels.paged_prefill_attention)
    pools = (kq, vq, ks, vs) if int8 else (kb, vb)
    before = kernel.launches
    with pytest.raises(ValueError, match="cannot be loaded by TMA"):
        kernel(_misaligned(q), *pools, bt, st)
    assert kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [8, 16])
def test_cuda_int8_row_with_one_key_rounds_only_at_the_output(cuda, ps):
    """A row at position 0 sees one key: p = 1, and the V scale enters P as
    the leading key's own (S / S = 1), so B4's output there is the plain
    version's rounded to bf16, bit for bit."""
    q, bt, _, _, (kq, vq, ks, vs) = _card_inputs(64, 1, ps, cuda, 5)
    st = torch.zeros(3, dtype=torch.int32, device=cuda)
    out = kernels.paged_prefill_attention_int8(q, kq, vq, ks, vs, bt, st)
    ref = kernels.paged_prefill_attention_int8_plain(
        q.float(), kq, vq, ks, vs, bt, st)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[:, 0], ref[:, 0].bfloat16(), atol=0,
                               rtol=0)
