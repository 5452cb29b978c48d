"""The cluster-split body of kernels B1 and B3 (paged single-token decode
attention, ``csrc/paged_decode_split.cuh``), and of B5 (dense decode at a
scalar position, ``csrc/decode_attention.cu``) over ``DenseRows``.

On the CPU: an emulation of the body's arithmetic — ``decode_splits``'s S,
each CTA's contiguous share of the row's needed pages by cluster rank, four
warps over disjoint keys of the share, each warp's lane groups with their
own online softmax over the keys the kernel's layout gives them (masked
keys weigh exactly 0; keys past the share clamp to its last row), int8
dot products scaled by the key's ``k_scale`` and p by its ``v_scale``, and
the one fp32 merge ``exp(m_s - m)`` over lane groups, warps and CTAs —
against the fp32 plain versions at 1e-5, over GQA groups 1, 5 and 16, pages
of 8 and 16, every mode, and the full-width groups 6, 7 (a kv head ending
in a partial tile of query rows) and 8 at pages of 16 in two modes each,
S 1-8 (also past the row's pages: empty splits),
pos 0, a page's last slot and a window whose masked keys fill whole
partials; ``decode_splits``; the C sources (every entry routes to the
body, which launches a cluster and merges through distributed shared
memory, and the old body is gone); the wrapper's 16-byte check. On a card
(marked ``cuda``, skipped here): the kernels against their plain versions
over the same S and edge cases, and a split count outside 1-8 refused.

B5: the same emulation over a dense cache read as ``DenseRows`` reads it
(block j of a row is cache rows 16 j .. 16 j + 15, the ragged last block
clamped to the cache's last row) against ``decode_attention_plain``, over
S 1-8, groups 1, 5 and 16, every mode, positions 0, 15, 16 and the last
row, a window crossing a block; the wrapper's S (``decode_splits`` over
the cache's blocks) and 16-byte check; CPU tensors ignore ``splits``; the
C source launches the split body over ``DenseRows`` in a cluster and the
old ``dense_decode_kernel`` is gone. On a card (``cuda``): the kernel
against its plain version over the same S and positions.

The emulations run on one torch thread (a module fixture, imported by the
other CPU-heavy port test files): under parallel test workers, torch's
intra-op threads oversubscribed the cores and slowed a case tenfold or
more. Inputs come from a numpy seed. The JAX package is not needed: the plain
versions are held against the Pallas kernels in ``test_torch_kernels.py``
and ``test_torch_quantkv.py``.
"""

from __future__ import annotations

import inspect
import math
import re

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (
    DENSE_BLOCK,
    MAX_SPLITS,
    NEG_INF,
    TILE_ROWS,
    _checked_splits,
    _dense_splits,
    decode_splits,
)
from repro_torch.models import quantise_kv_rows

TOL = 1e-5  # fp32 on both sides, summed in another order
WARPS = 4  # csrc/paged_decode_split.cuh: kWarps
MODES = [(None, None), (20, None), (None, 2.0), (20, 2.0)]  # window, softcap
GROUPS = (1, 5, 16)
# the full-width groups 6 (grok-1-314b: 48 over 8, softcap 30; a kv head
# ends in a partial tile of 2 rows), 7 (internvl2-1b: 14 over 2; 3 rows)
# and 8 (deepseek-67b, jamba: 64 over 8), two modes each at one page size
NEW_GROUPS = [(6, None, None, False), (6, None, 30.0, True),
              (7, None, None, False), (7, 20, None, True),
              (8, None, None, False), (8, 20, 2.0, True)]
SPLITS = range(1, MAX_SPLITS + 1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The emulations on one torch thread: under parallel test workers,
    torch's intra-op threads on every worker oversubscribe the cores and
    slow each case tenfold or more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layout(page_dtype: torch.dtype, dh: int) -> tuple[int, int]:
    """(lane groups a warp, unrolled keys a lane group) of the kernel's
    ``Layout``: 16 bytes a lane, a key row over ``dh / vec`` lanes."""
    vec = 16 // torch.empty((), dtype=page_dtype).element_size()
    keys = 32 // (dh // vec)
    return keys, (1 if keys >= 8 else 2 if keys >= 4 else 4)


def _merge(parts):
    """The body's one merge form over partials (m [..], l [..], acc [.., dh])
    stacked on dim 0: m = max m_s, weights exp(m_s - m)."""
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    mx = m.max(0).values
    w = torch.exp(m - mx)
    return mx, (w * l).sum(0), (w[..., None] * acc).sum(0)


def split_decode_emulation(q, k_pages, v_pages, block_tables, pos, *, splits,
                           window=None, softcap=None, k_scale=None,
                           v_scale=None, stats=None):
    """The cluster-split body's arithmetic in fp32 -> [B, H, dh] in q's
    dtype. ``stats`` (a dict) counts empty CTAs and lane-group partials
    that saw only masked keys."""
    b, h, dh = q.shape
    _, ps, kh, _ = k_pages.shape
    group = h // kh
    kkeys, unroll = _layout(k_pages.dtype, dh)
    step = kkeys * unroll
    sm_scale = 1.0 / math.sqrt(dh)
    stats = {} if stats is None else stats
    stats.setdefault("empty_ctas", 0)
    stats.setdefault("masked_partials", 0)
    out = torch.empty(b, h, dh)
    for bi in range(b):
        p = int(pos[bi])
        p_hi = min(p // ps, block_tables.shape[1] - 1)
        p_lo = max(p - window + 1, 0) // ps if window is not None else 0
        n = max(p_hi - p_lo + 1, 0)
        for hk in range(kh):
            qg = q[bi, hk * group:(hk + 1) * group].float()  # [G, dh]
            ctas = []
            for rank in range(splits):
                k_begin = (p_lo + rank * n // splits) * ps
                k_end = (p_lo + (rank + 1) * n // splits) * ps
                stats["empty_ctas"] += k_begin == k_end
                warps = []
                for w in range(WARPS):
                    m = torch.full((kkeys, group), NEG_INF)
                    l = torch.zeros(kkeys, group)
                    acc = torch.zeros(kkeys, group, dh)
                    for base in range(k_begin + w * step, k_end, WARPS * step):
                        # keys [U, lane groups]: base + u * kkeys + g
                        key = (base + torch.arange(unroll)[:, None] * kkeys
                               + torch.arange(kkeys)[None])
                        ok = (key < k_end) & (key <= p)
                        if window is not None:
                            ok &= key > p - window
                        kc = key.clamp(max=k_end - 1)
                        page = block_tables[bi, kc // ps].long()
                        t = kc % ps
                        kr = k_pages[page, t, hk].float()  # [U, KG, dh]
                        vr = v_pages[page, t, hk].float()
                        s = torch.einsum("gd,ukd->kgu", qg, kr)
                        if k_scale is not None:
                            s = s * k_scale[page, t].T[:, None]
                        s = s * sm_scale
                        if softcap is not None:
                            s = torch.tanh(s / softcap) * softcap
                        okk = ok.T[:, None]  # [KG, 1, U]
                        s = torch.where(okk, s, NEG_INF)
                        mn = torch.maximum(m, s.max(-1).values)
                        corr = torch.exp(m - mn)
                        pr = torch.where(okk, torch.exp(s - mn[..., None]), 0.0)
                        l = l * corr + pr.sum(-1)
                        if v_scale is not None:
                            pr = pr * v_scale[page, t].T[:, None]
                        acc = acc * corr[..., None] + torch.einsum(
                            "kgu,ukd->kgd", pr, vr)
                        m = mn
                    if k_begin + w * step < k_end:
                        stats["masked_partials"] += int((m[:, 0] == NEG_INF).sum())
                    warps.append(_merge(list(zip(m, l, acc))))
                ctas.append(_merge(warps))
            _, l, acc = _merge(ctas)
            out[bi, hk * group:(hk + 1) * group] = acc / l.clamp(min=1e-37)[:, None]
    return out.to(q.dtype)


def _case(group: int, ps: int, *, seed: int, int8: bool, dh: int = 16,
          pos=None, pages_bucket: int = 24):
    """Rows over a shared pool: pos 0, a page's last slot, the first slot of
    the next page, a short row and a long one; tables padded with the null
    page 0 past each row's pages and a stale id past the long row's."""
    rng = np.random.default_rng(seed)
    kh, n_pages = 2, 80
    pos = pos if pos is not None else [0, ps - 1, ps, 3 * ps + 5,
                                       pages_bucket * ps - 3]
    b = len(pos)
    q = torch.from_numpy(rng.standard_normal((b, kh * group, dh)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (n_pages, ps, kh, dh)).astype(np.float32)) for _ in range(2))
    bt = torch.zeros(b, pages_bucket, dtype=torch.int32)
    for r, p in enumerate(pos):
        need = p // ps + 1
        bt[r, :need] = torch.from_numpy(
            rng.choice(np.arange(1, n_pages), need, replace=False))
        if need < pages_bucket:
            bt[r, need:] = int(rng.integers(0, n_pages)) if r % 2 else 0
    pos = torch.tensor(pos, dtype=torch.int32)
    if int8:
        (kq, ks), (vq, vs) = quantise_kv_rows(kp), quantise_kv_rows(vp)
        return q, (kq, vq, ks, vs), bt, pos
    return q, (kp, vp), bt, pos


def _emulate(q, pages, bt, pos, *, splits, stats=None, **kw):
    if len(pages) == 4:
        kq, vq, ks, vs = pages
        return split_decode_emulation(q, kq, vq, bt, pos, splits=splits,
                                      k_scale=ks, v_scale=vs, stats=stats, **kw)
    return split_decode_emulation(q, *pages, bt, pos, splits=splits,
                                  stats=stats, **kw)


def _plain(q, pages, bt, pos, **kw):
    if len(pages) == 4:
        return kernels.paged_decode_attention_int8_plain(q, *pages, bt, pos, **kw)
    return kernels.paged_decode_attention_plain(q, *pages, bt, pos, **kw)


@pytest.mark.parametrize("int8", [False, True], ids=["model_dtype", "int8"])
@pytest.mark.parametrize("window,softcap", MODES)
@pytest.mark.parametrize("ps", (8, 16))
@pytest.mark.parametrize("group", GROUPS)
def test_split_emulation_matches_plain(group, ps, window, softcap, int8):
    """Every S 1-8 gives the plain version's result; the short rows leave
    CTAs without pages at the larger S."""
    q, pages, bt, pos = _case(group, ps, seed=group * ps + int8, int8=int8)
    kw = dict(window=window, softcap=softcap)
    ref = _plain(q, pages, bt, pos, **kw)
    stats = {}
    for s in SPLITS:
        out = _emulate(q, pages, bt, pos, splits=s, stats=stats, **kw)
        torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL,
                                   msg=lambda m: f"S={s}: {m}")
    assert stats["empty_ctas"] > 0


@pytest.mark.parametrize("group,window,softcap,int8", NEW_GROUPS)
def test_split_emulation_matches_plain_at_full_width_groups(group, window,
                                                            softcap, int8):
    """Groups 6, 7 and 8 at pages of 16: every S 1-8 gives the plain
    version's result."""
    q, pages, bt, pos = _case(group, 16, seed=group + int8, int8=int8)
    kw = dict(window=window, softcap=softcap)
    ref = _plain(q, pages, bt, pos, **kw)
    for s in SPLITS:
        out = _emulate(q, pages, bt, pos, splits=s, **kw)
        torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL,
                                   msg=lambda m: f"S={s}: {m}")


@pytest.mark.parametrize("int8", [False, True], ids=["model_dtype", "int8"])
@pytest.mark.parametrize("dh", (16, 64, 128))
def test_masked_and_empty_partials_weigh_nothing(dh, int8):
    """A window of 3 keys at the end of a page leaves the lane groups and
    warps before it with only masked keys (m = NEG_INF), and rows of one
    or two pages leave most of 8 CTAs empty; the merge gives both weight 0,
    so the result is the plain version's."""
    ps = 16
    pos = [0, 5, ps - 1, 5 * ps + 12, 2 * ps + 2]
    q, pages, bt, pos = _case(1, ps, seed=dh + int8, int8=int8, dh=dh,
                              pos=pos, pages_bucket=8)
    for window in (3, 1):
        ref = _plain(q, pages, bt, pos, window=window)
        for s in SPLITS:
            stats = {}
            out = _emulate(q, pages, bt, pos, splits=s, stats=stats,
                           window=window)
            torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
            assert stats["masked_partials"] > 0
            if s > 2:
                assert stats["empty_ctas"] > 0


@pytest.mark.parametrize("int8", [False, True], ids=["model_dtype", "int8"])
def test_served_shape_emulation_matches_plain(int8):
    """olmo-1b's decode shape cut down (G = 1, head_dim 128, page 16, 16
    pages a row) at the S the wrapper picks and at S 8."""
    q, pages, bt, pos = _case(1, 16, seed=3, int8=int8, dh=128,
                              pos=[96, 127, 200, 255], pages_bucket=16)
    ref = _plain(q, pages, bt, pos)
    for s in {decode_splits(4, 2, 1, 16), 8}:
        torch.testing.assert_close(_emulate(q, pages, bt, pos, splits=s), ref,
                                   atol=TOL, rtol=TOL)


def test_decode_splits_depends_on_shapes_only():
    """1 <= S <= 8, never past the table's pages, from (batch, kv heads,
    group, pages per row) alone; the timing shape (8 slots x 16 kv heads,
    G = 1, 16 pages) gets 4, i.e. 512 CTAs, a single row 8."""
    assert list(inspect.signature(decode_splits).parameters) == [
        "batch", "kv_heads", "group", "pages_per_row"]
    assert decode_splits(8, 16, 1, 16) == 4
    assert decode_splits(1, 16, 1, 16) == 8
    for b in (1, 2, 8, 64, 256):
        for kh in (1, 2, 8, 16):
            for g in (1, 2, 5, 16):
                for ppr in (1, 2, 5, 16, 64):
                    s = decode_splits(b, kh, g, ppr)
                    assert 1 <= s <= min(MAX_SPLITS, ppr)
                    assert s == decode_splits(b, kh, g, ppr)
    assert decode_splits(256, 16, 1, 64) == 1  # a full grid needs no split


def test_wrapper_checks_16_byte_alignment_and_picks_splits():
    q, (kp, vp), bt, _ = _case(5, 8, seed=0, int8=False)
    b, h, _ = q.shape
    assert _checked_splits("t", q, kp, vp, bt, None) == decode_splits(
        b, 2, 5, bt.shape[1])
    assert _checked_splits("t", q, kp, vp, bt, 3) == 3
    flat = torch.zeros(kp.numel() + 4)
    off = flat[1:1 + kp.numel()].view(kp.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _checked_splits("t", q, off, vp, bt, None)


@pytest.mark.parametrize("kernel", [kernels.paged_decode_attention,
                                    kernels.paged_decode_attention_int8],
                         ids=lambda k: k.__name__)
def test_cpu_tensors_ignore_splits_and_take_the_plain_version(kernel):
    int8 = kernel is kernels.paged_decode_attention_int8
    q, pages, bt, pos = _case(5, 8, seed=1, int8=int8)
    before = kernel.launches
    for s in (1, 8):
        torch.testing.assert_close(kernel(q, *pages, bt, pos, splits=s),
                                   _plain(q, pages, bt, pos), atol=0, rtol=0)
    assert kernel.launches == before


# ------------------------------------------------- B5 over DenseRows
def dense_as_pages(k, v):
    """A dense cache ``[B, KH, S, dh]`` (the wrapper's view) as the split
    body reads it through ``DenseRows``: block j of row b is cache rows
    16 j .. 16 j + 15, rows past S clamped to the last one -> (k_pages,
    v_pages, block_tables) for the emulation."""
    b, kh, seq, dh = k.shape
    nb = -(-seq // DENSE_BLOCK)
    rows = torch.arange(nb * DENSE_BLOCK).clamp(max=seq - 1)

    def pages(t):
        return t.transpose(1, 2)[:, rows].reshape(b * nb, DENSE_BLOCK, kh, dh)

    bt = torch.arange(b * nb, dtype=torch.int32).reshape(b, nb)
    return pages(k), pages(v), bt


def _dense_case(group: int, *, seed: int, seq: int = 70, dh: int = 16,
                device="cpu", dtype=torch.float32):
    """q [B, H, dh] and the model's [B, S, KH, dh] cache passed transposed,
    a view; S ragged against the 16-row blocks."""
    rng = np.random.default_rng(seed)
    b, kh = 2, 2
    q = torch.from_numpy(rng.standard_normal(
        (b, kh * group, dh)).astype(np.float32)).to(device, dtype)
    k, v = (torch.from_numpy(rng.standard_normal(
        (b, seq, kh, dh)).astype(np.float32)).to(device, dtype).transpose(1, 2)
        for _ in range(2))
    return q, k, v


def dense_split_emulation(q, k, v, pos: int, *, splits, **kw):
    kp, vp, bt = dense_as_pages(k, v)
    return split_decode_emulation(
        q, kp, vp, bt, torch.full((q.shape[0],), pos, dtype=torch.int32),
        splits=splits, **kw)


DENSE_POSITIONS = (0, 15, 16, 41, 69)  # block edges, mid, the last row


@pytest.mark.parametrize("window,softcap", MODES)
@pytest.mark.parametrize("group", GROUPS)
def test_dense_split_emulation_matches_plain(group, window, softcap):
    """Every S 1-8 at every position gives ``decode_attention_plain``'s
    result; at pos 41 the window of 20 crosses the block edge at 32."""
    q, k, v = _dense_case(group, seed=group)
    kw = dict(window=window, softcap=softcap)
    stats = {}
    for pos in DENSE_POSITIONS:
        ref = kernels.decode_attention_plain(
            q, k, v, torch.tensor(pos, dtype=torch.int32), **kw)
        for s in SPLITS:
            out = dense_split_emulation(q, k, v, pos, splits=s, stats=stats,
                                        **kw)
            torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL,
                                       msg=lambda m: f"pos={pos} S={s}: {m}")
    assert stats["empty_ctas"] > 0


def test_dense_burst_shape_emulation_matches_plain():
    """The burst step's shape cut down (G = 1, head_dim 128, pos 255 of a
    longer cache) at the S the wrapper picks and at S 8."""
    q, k, v = _dense_case(1, seed=4, seq=300, dh=128)
    pos = torch.tensor(255, dtype=torch.int32)
    ref = kernels.decode_attention_plain(q, k, v, pos)
    for s in {_dense_splits("t", q, k, v, None), 8}:
        torch.testing.assert_close(
            dense_split_emulation(q, k, v, 255, splits=s), ref, atol=TOL,
            rtol=TOL)


def test_dense_wrapper_picks_splits_and_checks_16_byte_strides():
    """S = ``decode_splits(B, KH, G, blocks)``: the burst shape (8 rows x
    16 kv heads, a 1024-row cache) gets 4, i.e. 512 CTAs; k/v must start
    16-byte aligned with strides of 16-byte multiples."""
    q, k, v = _dense_case(5, seed=0)
    b, h, _ = q.shape
    assert _dense_splits("t", q, k, v, None) == decode_splits(
        b, 2, 5, -(-70 // DENSE_BLOCK))
    assert _dense_splits("t", q, k, v, 3) == 3
    q8 = torch.zeros(8, 16, 128, dtype=torch.bfloat16)
    cache = torch.zeros(8, 1024, 16, 128, dtype=torch.bfloat16).transpose(1, 2)
    assert _dense_splits("t", q8, cache, cache, None) == 4
    flat = torch.zeros(k.numel() + 4)
    shifted = flat[1:1 + k.numel()].view(2, 70, 2, 16).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _dense_splits("t", q, shifted, v, None)
    wide = torch.zeros(2, 70, 2 * 16 + 2)[..., :32].reshape(
        2, 70, 2, 16).transpose(1, 2)  # sequence stride 34 floats
    with pytest.raises(ValueError, match="16-byte"):
        _dense_splits("t", q, wide, wide, None)


def test_dense_cpu_tensors_ignore_splits_and_take_the_plain_version():
    q, k, v = _dense_case(5, seed=1)
    pos = torch.tensor(41, dtype=torch.int32)
    before = kernels.decode_attention.launches
    for s in (1, 8):
        torch.testing.assert_close(
            kernels.decode_attention(q, k, v, pos, splits=s, window=20),
            kernels.decode_attention_plain(q, k, v, pos, window=20),
            atol=0, rtol=0)
    assert kernels.decode_attention.launches == before


# ------------------------------------------------------------- the sources
def _body(src: str, signature: str) -> str:
    return src.split(signature)[1].split("\n}\n")[0]


@pytest.mark.parametrize("source,entry", [
    ("paged_attention.cu", "paged_decode_attention"),
    ("paged_attention_int8.cu", "paged_decode_attention_int8"),
])
def test_decode_entry_points_launch_the_split_body(source, entry):
    """Every (dtype code, head_dim) the wrappers accept goes to the split
    body, and the entry point neither allocates nor syncs."""
    src = (build.CSRC / source).read_text()
    assert '#include "paged_decode_split.cuh"' in src
    body = _body(src, f'extern "C" int {entry}(')
    routes = {(int(d), int(hd)): fn for d, hd, fn in re.findall(
        r"if \(dtype == (\d) && head_dim == (\d+)\) return (\w+)", body)}
    assert set(routes) == build.instantiated()
    assert set(routes.values()) == {"launch_decode_split"}
    assert "splits" in body
    for call in ("cudaMalloc", "Synchronize", "cudaMemcpy", "new "):
        assert call not in body, call


def test_split_body_launches_a_cluster_and_merges_through_dsmem():
    src = (build.CSRC / "paged_decode_split.cuh").read_text()
    assert "paged_decode_split.cuh" in build.HEADERS
    launch = _body(src, "struct SplitLaunch {")
    assert re.search(r"launch_split\([^;]*a\.splits", launch)
    clusters = _body(src, "cudaError_t launch_split(")
    assert "cudaLaunchKernelEx(" in clusters
    assert "cudaLaunchAttributeClusterDimension" in clusters
    assert "clusterDim.z = splits" in clusters
    # decode_splits counts CTAs with the kernel's own constants
    assert f"constexpr int kMaxSplits = {MAX_SPLITS};" in src
    assert f"constexpr int kTileRows = {TILE_ROWS};" in src
    assert f"constexpr int kWarps = {WARPS};" in src
    body = _body(src, "__device__ __forceinline__ void decode_split(")
    assert body.count("cluster.sync()") == 2
    assert "map_shared_rank(" in body
    assert "return" not in body  # an early return would deadlock the cluster
    for call in (r"cudaMalloc\w*\(", r"\batomic\w*\(", r"Synchronize\("):
        assert not re.search(call, src), call
    # the kernel's name keeps "paged_decode" for the profiler's filters
    assert "paged_decode_split_kernel(" in src


def test_old_decode_body_is_gone():
    for path in build.CSRC.iterdir():
        text = path.read_text()
        assert "paged_decode_kernel" not in text, path.name
        assert "DecodeLaunch" not in text, path.name


def test_dense_decode_launches_the_split_body_over_dense_rows():
    """B5: one clustered launch of ``decode_split`` over ``DenseRows`` per
    call, S CTAs a cluster, S checked in the entry point; the earlier body
    (``dense_decode_kernel`` over ``attend_pages``) is gone, and
    ``attend_pages`` serves only the CUDA-core paged prefill."""
    src = (build.CSRC / "decode_attention.cu").read_text()
    assert '#include "paged_decode_split.cuh"' in src
    kernel = _body(src, "dense_decode_split_kernel(")
    assert "paged::DenseRows<kDenseBlock>" in kernel
    assert "paged_split::decode_split<" in kernel
    assert "*pos" in kernel  # the position is read on the device
    assert "return" not in kernel  # every CTA reaches the cluster barriers
    # the clusters of (1, 1, S) of B1/B3's launch (launch_split)
    assert re.search(r"paged_split::launch_split\([^;]*a\.splits", src)
    entry = _body(src, 'extern "C" int dense_decode_attention(')
    assert "splits > kMaxSplits" in entry
    for call in ("cudaMalloc", "Synchronize", "cudaMemcpy", "new "):
        assert call not in entry, call
    assert "kDenseBlock = 16;" in (build.CSRC / "paged_attention.cuh").read_text()
    assert DENSE_BLOCK == 16
    uses = {}
    for path in build.CSRC.iterdir():
        text = path.read_text()
        assert "dense_decode_kernel" not in text, path.name
        assert "kDecodeRows" not in text, path.name
        uses[path.name] = len(re.findall(r"\battend_pages<", text))
    assert {k: n for k, n in uses.items() if n} == {"paged_attention.cuh": 1}
    assert "attend_pages<" in _body(
        (build.CSRC / "paged_attention.cuh").read_text(),
        "    paged_prefill_kernel(")


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("int8", [False, True], ids=["model_dtype", "int8"])
@pytest.mark.parametrize("window,softcap", MODES)
@pytest.mark.parametrize("ps", (8, 16))
@pytest.mark.parametrize("group", GROUPS)
def test_cuda_split_kernel_matches_plain_over_splits(
    cuda, group, ps, window, softcap, int8, dtype, atol
):
    """fp32: same sums, another order -> 1e-4; bf16: the output rounded to
    bf16 -> 2e-2. One launch per call at every S."""
    kernel = (kernels.paged_decode_attention_int8 if int8
              else kernels.paged_decode_attention)
    for dh in (16, 128):
        q, pages, bt, pos = _case(group, ps, seed=group + ps, int8=int8, dh=dh)
        q, bt, pos = q.to(cuda, dtype), bt.to(cuda), pos.to(cuda)
        pages = tuple(p.to(cuda) for p in pages)
        if not int8:
            pages = tuple(p.to(dtype) for p in pages)
        kw = dict(window=window, softcap=softcap)
        ref = _plain(q.float(), tuple(p.float() if p.dtype != torch.int8
                                      else p for p in pages), bt, pos, **kw)
        for s in SPLITS:
            before = kernel.launches
            out = kernel(q, *pages, bt, pos, splits=s, **kw)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0,
                                       msg=lambda m: f"dh={dh} S={s}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("group,window,softcap,int8", NEW_GROUPS)
def test_cuda_split_kernel_matches_plain_at_full_width_groups(
    cuda, group, window, softcap, int8, dtype, atol
):
    """Groups 6 and 7 (a partial tile of 2 or 3 query rows a kv head) and
    8 at pages of 16, dh 128 and 64, every S."""
    kernel = (kernels.paged_decode_attention_int8 if int8
              else kernels.paged_decode_attention)
    for dh in (64, 128):
        q, pages, bt, pos = _case(group, 16, seed=group, int8=int8, dh=dh)
        q, bt, pos = q.to(cuda, dtype), bt.to(cuda), pos.to(cuda)
        pages = tuple(p.to(cuda) for p in pages)
        if not int8:
            pages = tuple(p.to(dtype) for p in pages)
        kw = dict(window=window, softcap=softcap)
        ref = _plain(q.float(), tuple(p.float() if p.dtype != torch.int8
                                      else p for p in pages), bt, pos, **kw)
        for s in SPLITS:
            out = kernel(q, *pages, bt, pos, splits=s, **kw)
            torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0,
                                       msg=lambda m: f"dh={dh} S={s}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [0, MAX_SPLITS + 1])
def test_cuda_split_count_outside_1_to_8_is_refused(cuda, splits):
    q, (kp, vp), bt, pos = _case(1, 8, seed=2, int8=False)
    with pytest.raises(RuntimeError, match="cudaError"):
        kernels.paged_decode_attention(q.to(cuda), kp.to(cuda), vp.to(cuda),
                                       bt.to(cuda), pos.to(cuda), splits=splits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window,softcap", MODES)
@pytest.mark.parametrize("group", GROUPS)
def test_cuda_dense_decode_matches_plain_over_splits_and_positions(
    cuda, group, window, softcap, dtype, atol
):
    """B5 at every S 1-8, positions 0, 15, 16, 41 (the window of 20 crosses
    a block) and the last row of a ragged cache, on the model's layout as a
    view; fp32 1e-4, bf16 2e-2 (as B1's). One launch per call."""
    kw = dict(window=window, softcap=softcap)
    for dh in (16, 128):
        q, k, v = _dense_case(group, seed=group + dh, dh=dh, device=cuda,
                              dtype=dtype)
        for pos in DENSE_POSITIONS:
            p = torch.tensor(pos, dtype=torch.int32, device=cuda)
            ref = kernels.decode_attention_plain(q.float(), k.float(),
                                                 v.float(), p, **kw)
            for s in SPLITS:
                before = kernels.decode_attention.launches
                out = kernels.decode_attention(q, k, v, p, splits=s, **kw)
                torch.cuda.synchronize()
                assert kernels.decode_attention.launches == before + 1
                torch.testing.assert_close(
                    out.float(), ref, atol=atol, rtol=0,
                    msg=lambda m: f"dh={dh} pos={pos} S={s}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [0, MAX_SPLITS + 1])
def test_cuda_dense_split_count_outside_1_to_8_is_refused(cuda, splits):
    q, k, v = _dense_case(1, seed=2, device=cuda)
    with pytest.raises(RuntimeError, match="cudaError"):
        kernels.decode_attention(q, k, v, torch.tensor(
            3, dtype=torch.int32, device=cuda), splits=splits)
