"""The tensor-core body of kernel B8 (the Mamba-2 SSD chunked scan,
``csrc/ssd_chunk_tc.cuh``), bf16 at chunk 256, head dim 64, state 128.

On the CPU: an emulation of the body's arithmetic — 64-row query and key
tiles, only the tiles that hold a row inside S; G = (C·Bᵀ)·exp(cum_i −
cum_j)·dt_j on the causal triangle and 0 above it, split into hi + lo
bf16 terms for G·x; the inter term from the state's bf16 copy; the state
update with B∘w split into hi + lo bf16 terms; rows past S as dt = 0 —
against
``ssd_chunk_plain`` (which ``test_torch_ssm.py`` holds against the Pallas
kernel) at the tolerances ``chip_smoke.py`` holds the card to, over
S 1, 255, 256, 257, 1024 and 1056 with B and C as stride-0 group views;
once against the Pallas kernel in interpret mode directly; with B∘w
rounded once, which breaks the state's tolerance, and G rounded once,
which costs y ~20x the split's rms error (why both are split). The C
sources: bf16 at (256, 64, 128) routes to the tensor-core body, everything
else to ``ssd_chunk_kernel``; the body issues wgmma and never syncs with
the host; a producer warpgroup streams the tiles through mbarrier rings
smaller than a chunk; the wrapper's alignment check. On a card (marked
``cuda``, skipped here): the kernel against its plain version at those
lengths (y's rms error too), one launch a call, and a misaligned operand
refused.

Inputs come from a numpy seed, drawn as ``chip_smoke.py`` draws them. JAX
is imported inside the one test that needs it, so the ``cuda`` tests run on
a card's machine without it.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.ssd_chunk import TC_SHAPE, check_tc_alignment
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

L, P, N = TC_SHAPE
TILE = 64  # csrc/ssd_chunk_tc.cuh: kTile
# chip_smoke.py's SSD_REL_TOL[bfloat16] and SSD_STATE_REL_TOL (relative to
# the largest |output|): y rounded to bf16 -> 1e-2, the fp32 state -> 2e-4
Y_REL_TOL = 1e-2
STATE_REL_TOL = 2e-4
# chip_smoke.py's SSD_Y_RMS_TOL: y's rms error over y's rms, between the
# split G's ~1e-4 and one rounding of G's ~3e-3
Y_RMS_TOL = 1e-3
LENGTHS = (1, 255, 256, 257, 1024, 1056)


def _inputs(b: int, s: int, h: int, *, seed: int, device="cpu"):
    """B8's operands as the mixer hands them over, bf16: x a strided view of
    one xBC tensor, B and C its one group as stride-0 views over the heads,
    dt a softplus in fp32, A = -exp(.) per head."""
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(rng.standard_normal(
        (b, s, h * P + 2 * N)).astype(np.float32)).to(device, torch.bfloat16)
    x = xbc[..., : h * P].reshape(b, s, h, P)
    bm, cm = (xbc[..., h * P + i * N: h * P + (i + 1) * N].reshape(
        b, s, 1, N).expand(b, s, h, N) for i in (0, 1))
    dt = F.softplus(torch.from_numpy(
        rng.standard_normal((b, s, h)).astype(np.float32))).to(device)
    a = -torch.exp(torch.from_numpy(
        rng.standard_normal(h).astype(np.float32) * 0.3)).to(device)
    return x, bm, cm, dt, a


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _terms(v: torch.Tensor, split: bool) -> tuple:
    """v as the bf16 terms the body multiplies: hi + lo, or hi alone."""
    hi = _bf16(v)
    return (hi, _bf16(v - hi)) if split else (hi,)


def tc_emulation(x, b, c, dt, a, *, split: bool = True, split_g: bool = True):
    """The tensor-core body's arithmetic in fp32 -> (y [B, S, H, P] bf16,
    state [B, H, P, N] fp32). ``split`` / ``split_g`` False round B∘w / G
    once to bf16."""
    bsz, s, h, p = x.shape
    heads_first = [t.float().transpose(1, 2) for t in (x, b, c, dt)]
    xf, bf, cf, dtf = heads_first  # [B, H, S, *], dt [B, H, S]
    state = torch.zeros(bsz, h, p, b.shape[-1])
    y = torch.zeros(bsz, h, s, p)
    for r0 in range(0, s, L):
        rows = min(L, s - r0)
        tiles = -(-rows // TILE)
        xc, bc, cc = (F.pad(t[:, :, r0:r0 + rows], (0, 0, 0, L - rows))
                      for t in (xf, bf, cf))
        dc = F.pad(dtf[:, :, r0:r0 + rows], (0, L - rows))  # dt = 0 past S
        cum = torch.cumsum(dc * a[None, :, None], dim=-1)
        total = cum[..., -1:]
        s_op = _bf16(state)  # the state's bf16 copy, before the update
        for qt in range(tiles):
            q = slice(qt * TILE, (qt + 1) * TILE)
            yq = (cc[:, :, q] @ s_op.transpose(-1, -2)) * torch.exp(
                cum[:, :, q])[..., None]
            for kt in range(qt + 1):
                k = slice(kt * TILE, (kt + 1) * TILE)
                i = torch.arange(q.start, q.stop)[:, None]
                j = torch.arange(k.start, k.stop)[None, :]
                causal = j <= i
                seg = (cum[:, :, q, None] - cum[:, :, None, k]).masked_fill(
                    ~causal, 0.0)
                g = torch.where(causal, (cc[:, :, q] @ bc[:, :, k].transpose(
                    -1, -2)) * torch.exp(seg) * dc[:, :, None, k], 0.0)
                for term in _terms(g, split_g):
                    yq = yq + term @ xc[:, :, k]
            keep = min(TILE, rows - qt * TILE)
            y[:, :, r0 + q.start: r0 + q.start + keep] = yq[:, :, :keep]
        w = torch.exp(total - cum) * dc
        state = state * torch.exp(total)[..., None]
        for kt in range(tiles):
            k = slice(kt * TILE, (kt + 1) * TILE)
            for term in _terms(bc[:, :, k] * w[:, :, k, None], split):
                state = state + xc[:, :, k].transpose(-1, -2) @ term
    return y.transpose(1, 2).to(torch.bfloat16).contiguous(), state


def _rel_errs(out, ref) -> tuple[float, float]:
    """Max abs error of y and of the state, each over the largest |ref|
    (``chip_smoke.py:_ssd_errs``)."""
    return tuple(float((o.float() - r.float()).abs().max()
                       / r.float().abs().max()) for o, r in zip(out, ref))


def _y_rms(y, ref_y) -> float:
    """y's rms error over the reference's rms (``chip_smoke.py:_ssd_y_rms``)."""
    ref = ref_y.float()
    return float((y.float() - ref).pow(2).mean().sqrt()
                 / ref.pow(2).mean().sqrt())


@pytest.mark.parametrize("s", LENGTHS)
def test_emulation_matches_plain(s):
    """Every length, ragged tails and S < L included, within the card's
    tolerances; B and C stay stride-0 views."""
    args = _inputs(2, s, 4, seed=s)
    assert args[1].stride(2) == 0 and not args[0].is_contiguous()
    ref = kernels.ssd_chunk_plain(*args, chunk=L)
    out = tc_emulation(*args)
    ey, es = _rel_errs(out, ref)
    assert ey <= Y_REL_TOL, ey
    assert es <= STATE_REL_TOL, es
    assert _y_rms(out[0], ref[0]) <= Y_RMS_TOL


def test_emulation_matches_the_pallas_kernel():
    """The same emulation against the JAX package's Pallas kernel in
    interpret mode (it takes S a multiple of the chunk and B/C per head).
    JAX is imported here only: the ``cuda`` tests run where it is absent."""
    import jax.numpy as jnp

    from repro.kernels import ssd_chunk as jax_ssd_chunk

    x, bm, cm, dt, a = _inputs(1, 2 * L, 2, seed=7)
    jy, js = jax_ssd_chunk(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, bm, cm)),
        jnp.asarray(dt.numpy()), jnp.asarray(a.numpy()), chunk=L,
        interpret=True)
    ref = (torch.from_numpy(np.array(jy, np.float32)),
           torch.from_numpy(np.array(js, np.float32)))
    ey, es = _rel_errs(tc_emulation(x, bm, cm, dt, a), ref)
    assert ey <= Y_REL_TOL, ey
    assert es <= STATE_REL_TOL, es


def test_one_bf16_rounding_of_the_state_update_breaks_its_tolerance():
    """B∘w is not bf16-exact: rounded once, the state misses 2e-4 by far;
    split in hi + lo it is within it — why the body runs two wgmma chains."""
    args = _inputs(2, 1024, 4, seed=11)
    ref = kernels.ssd_chunk_plain(*args, chunk=L)
    _, es_once = _rel_errs(tc_emulation(*args, split=False), ref)
    _, es_split = _rel_errs(tc_emulation(*args), ref)
    assert es_once > 4 * STATE_REL_TOL, es_once
    assert es_split < STATE_REL_TOL / 4, es_split


def test_one_bf16_rounding_of_g_costs_y_an_order_of_magnitude():
    """G rounded once to bf16 stays inside y's 1e-2 (max over max) but
    puts ~3e-3 rms error on y, which 48 layers carry to the logits; split
    in hi + lo, y's rms error is the state operand's ~1e-4."""
    args = _inputs(2, 1056, 8, seed=13)
    ref = kernels.ssd_chunk_plain(*args, chunk=L)[0]
    once = _y_rms(tc_emulation(*args, split_g=False)[0], ref)
    split = _y_rms(tc_emulation(*args)[0], ref)
    assert once > Y_RMS_TOL and split < once / 10, (once, split)


def test_alignment_check_takes_the_mixer_views_and_refuses_the_rest():
    x, bm, cm, _, _ = _inputs(2, 40, 4, seed=1)
    check_tc_alignment("t", x, bm, cm)  # strided x, stride-0 B/C: fine
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_tc_alignment("t", shifted, bm, cm)
    odd = torch.zeros(2, 40, 4 * P + 4, dtype=torch.bfloat16)[..., : 4 * P]
    with pytest.raises(ValueError, match="multiple of 8"):
        check_tc_alignment("t", x, odd.reshape(2, 40, 4, P)[..., :1, :], cm)


# ------------------------------------------------------------- the sources
def _entry() -> str:
    src = (build.CSRC / "ssd_chunk.cu").read_text()
    return src.split('extern "C" int ssd_chunk(')[1]


def test_entry_point_routes_bf16_full_width_to_the_tensor_core_body():
    body = _entry()
    route = re.search(
        r"if \(dtype == 1 && chunk == ssd_tc::kL && headdim == ssd_tc::kP &&"
        r"\s+state_dim == ssd_tc::kN\)\s+return ssd_tc::launch\(", body)
    assert route, "bf16 (256, 64, 128) must go to the tensor-core body"
    # the route comes first; fp32 and bf16 at every other shape go on to
    # by_shape, whose launches are ssd_chunk_kernel's, fp32 alone at 256
    assert body.index("ssd_tc::launch(") < body.index("by_shape<float>")
    tc = (build.CSRC / "ssd_chunk_tc.cuh").read_text()
    assert (f"constexpr int kL = {L}, kP = {P}, kN = {N};" in tc)
    src = (build.CSRC / "ssd_chunk.cu").read_text()
    by_shape = src.split("cudaError_t by_shape(")[1].split("\n}\n")[0]
    assert re.search(r"if constexpr \(std::is_same<T, float>::value\) \{\s+"
                     r"REPRO_SSD\(256, 64, 128\);", by_shape)
    assert "ssd_chunk_kernel<T, L, P, N>" in src
    assert "ssd_chunk_tc.cuh" in build.HEADERS
    for call in ("cudaMalloc", "Synchronize", "cudaMemcpy", "new "):
        assert call not in body, call


def test_tensor_core_body_issues_wgmma_and_never_syncs_the_host():
    tc = (build.CSRC / "ssd_chunk_tc.cuh").read_text()
    kernel = tc.split("ssd_chunk_tc_kernel(")[1].split("\n}\n")[0]
    assert "wgmma_ss(" in kernel and "wgmma_rs(" in kernel
    assert "wgmma_ss<1, 1>(" in kernel  # xᵀ and the B∘w terms MN-major
    assert "split_scaled(" in kernel  # the hi + lo terms
    assert "cp_async_16(" in kernel
    for call in (r"cudaMalloc\w*\(", r"Synchronize\(", r"cudaMemcpy\w*\(",
                 r"\batomic\w*\("):
        assert not re.search(call, tc), call
    # the profiler's filters and chip_smoke.py's profile check use the name
    assert "__global__ void __launch_bounds__(kThreads, 1)\n    ssd_chunk_tc_kernel(" in tc


def _constants(src: str) -> dict:
    """The header's ``constexpr int`` values, evaluated in order; those of
    namespace ``ssd`` as ``ssd_<name>``."""
    env = {}
    shared, own = src.split("namespace ssd_tc {")
    for prefix, part_src in (("ssd_", shared), ("", own)):
        for decl in re.findall(r"constexpr int ([^;]+);", part_src):
            for part in re.split(r",\s*(?=k\w+ =)", decl):
                name, expr = (t.strip() for t in part.split("=", 1))
                expr = expr.replace("ssd::", "ssd_")
                if prefix:
                    expr = re.sub(r"\b(k\w+)", r"ssd_\1", expr)
                env[prefix + name] = eval(expr, {}, dict(env))
    return env


def test_tensor_core_body_streams_key_tiles_through_an_mbarrier_ring():
    """A producer warp streams the chunk's tiles into two rings behind full
    and empty mbarriers while the two consumer warpgroups run the products;
    what is resident at once (both rings) is less than one chunk of C, B
    and x, so no chunk is staged whole."""
    tc = (build.CSRC / "ssd_chunk_tc.cuh").read_text()
    k = _constants(tc)
    assert k["kThreads"] == 3 * 128  # two consumer warpgroups, one producer
    # the producer hands registers to the consumers within the block's pool
    assert (128 * k["kProducerRegs"] + 256 * k["kConsumerRegs"]
            <= 65536 // k["kThreads"] // 8 * 8 * k["kThreads"])
    assert k["kKStages"] >= 2 and k["kQStages"] >= 2
    chunk_bytes = L * (2 * N + P) * 2
    assert k["kQStages"] * k["kQItem"] + k["kKStages"] * k["kKItem"] < chunk_bytes
    assert k["kSmem"] <= 227 * 1024
    kernel = tc.split("ssd_chunk_tc_kernel(")[1].split("\n}\n")[0]
    producer, consumers = kernel.split("// ---- the two consumer warpgroups")
    assert "setmaxnreg_dec<kProducerRegs>()" in producer
    assert "setmaxnreg_inc<kConsumerRegs>()" in consumers
    for call in ("mbar_wait(q_empty", "mbar_wait(k_empty", "cp_async_16(",
                 "cp_async_commit()", "cp_async_wait<1>()",
                 "fence_proxy_async()", "mbar_arrive(landing)"):
        assert call in producer, call
    assert not re.search(r"wgmma_\w+\(", producer)
    for call in ("mbar_wait(q_full", "mbar_wait(k_full",
                 "mbar_arrive(k_empty", "mbar_arrive(q_empty"):
        assert call in consumers, call
    assert "cp_async" not in consumers and "__syncthreads" not in consumers


def test_tolerances_are_chip_smokes():
    from pathlib import Path

    smoke = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    rel = re.search(r"SSD_REL_TOL = \{torch.float32: ([\d.e-]+), "
                    r"torch.bfloat16: ([\d.e-]+)\}", smoke)
    state = re.search(r"SSD_STATE_REL_TOL = ([\d.e-]+)", smoke)
    rms = re.search(r"SSD_Y_RMS_TOL = ([\d.e-]+)", smoke)
    assert float(rel.group(2)) == Y_REL_TOL
    assert float(state.group(1)) == STATE_REL_TOL
    assert float(rms.group(1)) == Y_RMS_TOL


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s", LENGTHS + (2048,))
def test_cuda_tensor_core_body_matches_plain(cuda, s):
    """One launch a call; y 1e-2 and the state 2e-4 relative, and y's rms
    error 1e-3, as on the CPU emulation."""
    args = _inputs(2, s, 32, seed=s, device=cuda)
    before = kernels.ssd_chunk.launches
    out = kernels.ssd_chunk(*args, chunk=L)
    ref = kernels.ssd_chunk_plain(*args, chunk=L)
    torch.cuda.synchronize()
    assert kernels.ssd_chunk.launches == before + 1
    assert out[0].dtype == torch.bfloat16 and out[0].is_contiguous()
    ey, es = _rel_errs(out, ref)
    assert ey <= Y_REL_TOL, ey
    assert es <= STATE_REL_TOL, es
    rms = _y_rms(out[0], ref[0])
    assert rms <= Y_RMS_TOL, rms


@pytest.mark.cuda
def test_cuda_misaligned_operand_is_refused(cuda):
    x, bm, cm, dt, a = _inputs(1, 64, 2, seed=3, device=cuda)
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.ssd_chunk(shifted, bm, cm, dt, a, chunk=L)
