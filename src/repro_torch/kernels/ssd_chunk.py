"""Mamba-2 SSD chunked scan, kernel B8: CUDA wrapper, launch count, plain
version.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_chunk.py:ssd_chunk``
(arXiv:2405.21060 §6). Inputs ``x [B, S, H, P]`` and ``b``/``c [B, S, G,
N]`` in the model dtype (G divides H; head h reads group h // (H / G), so a
``[B, S, H, N]`` stride-0 ``expand`` of one group is taken as it is),
``dt [B, S, H]`` float32 after softplus and ``A [H]`` float32, negative.
Outputs ``y [B, S, H, P]`` in x's dtype and the final state ``[B, H, P, N]``
float32, from a zero initial state.

On the card (``csrc/ssd_chunk.cu``) one block serves one (batch row, head)
and walks the chunks in order, the ``[P, N]`` state in shared memory for the
whole loop and written once at the end. The chunk length L, P and N are
template parameters (chunk-size specialisation, this family's analogue of
the attention kernels' mode), and a ragged tail is masked in the kernel:
rows past S act as ``dt = 0``, so any S gives ``ssd_scan``'s result. The
inputs are read through element strides (the last axis needs unit stride).

The wrapper runs the plain version only for CPU tensors. For CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

# (chunk L, head dim P, state N) instantiated in csrc/ssd_chunk.cu, each for
# float32 and bfloat16: mamba2-370m at full width, and the smoke config with
# the JAX package's kernel-test chunks.
SSD_SHAPES = ((256, 64, 128), (4, 16, 16), (8, 16, 16), (16, 16, 16))


def check_ssd_operands(name: str, x, b, c, dt, a, chunk: int) -> None:
    """Validate what B8 takes; raise on anything else."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    for t in (b, c, dt, a):
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
    if x.dtype not in build.DTYPE_CODES or b.dtype != x.dtype or (
        c.dtype != x.dtype
    ):
        raise ValueError(
            f"{name}: x, b, c must share one of {tuple(build.DTYPE_CODES)}, "
            f"got {x.dtype}/{b.dtype}/{c.dtype}"
        )
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"{name}: dt and A must be float32")
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(
            f"{name}: bad shapes x{tuple(x.shape)} b{tuple(b.shape)} "
            f"c{tuple(c.shape)}"
        )
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if tuple(b.shape[:2]) != (bsz, s) or g == 0 or h % g != 0 or s == 0:
        raise ValueError(
            f"{name}: b/c{tuple(b.shape)} do not fit x{tuple(x.shape)}"
        )
    if tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,):
        raise ValueError(
            f"{name}: dt{tuple(dt.shape)} / A{tuple(a.shape)} do not fit "
            f"x{tuple(x.shape)}"
        )
    if any(t.stride(-1) != 1 for t in (x, b, c)) or not a.is_contiguous():
        raise ValueError(f"{name}: the last axis of x, b, c must have unit "
                         f"stride and A must be contiguous")
    if (chunk, p, n) not in SSD_SHAPES:
        raise ValueError(
            f"{name}: no kernel instantiated for chunk={chunk}, headdim={p}, "
            f"state={n} (instantiated (chunk, headdim, state): {SSD_SHAPES})"
        )


def ssd_chunk(
    x: torch.Tensor,  # [B, S, H, P]
    b: torch.Tensor,  # [B, S, G, N]
    c: torch.Tensor,  # [B, S, G, N]
    dt: torch.Tensor,  # [B, S, H] post-softplus, float32
    a: torch.Tensor,  # [H] negative decay rates, float32
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan with chunk length ``chunk`` -> (y [B, S, H, P] contiguous,
    state [B, H, P, N] float32)."""
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, b, c, dt, a, chunk=chunk)
    name = "ssd_chunk"
    check_ssd_operands(name, x, b, c, dt, a, chunk)
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    state = torch.empty(bsz, h, p, n, dtype=torch.float32, device=x.device)
    rc = build.load().ssd_chunk(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(), a.data_ptr(),
        y.data_ptr(), state.data_ptr(), bsz, s, h, h // g,
        *x.stride()[:3], *b.stride()[:3], *c.stride()[:3], *dt.stride(),
        build.DTYPE_CODES[x.dtype], chunk, p, n,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.raise_on_error(name, rc)
    ssd_chunk.launches += 1
    return y, state


ssd_chunk.launches = 0  # kernel launches (CUDA path only)


def ssd_chunk_plain(
    x: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B8: the Pallas kernel's per-chunk body
    (``ssd_chunk.py:26-70``) in float32, batched over (batch, head), chunk
    after chunk with the state carried between them. The length is padded
    to a chunk multiple with ``dt = 0`` rows (``ssd_scan``'s rule), so any
    S works; the decay is exponentiated on the causal triangle only."""
    bsz, s, h, p = x.shape
    L = chunk
    nc = -(-s // L)
    pad = nc * L - s
    reps = h // b.shape[2]

    def heads_first(t: torch.Tensor) -> torch.Tensor:  # [B,S',H,*]->[B,H,S',*]
        if t.dim() == 4 and t.shape[2] != h:
            t = t.repeat_interleave(reps, dim=2)
        t = t.float()
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.transpose(1, 2)

    xf, bf, cf, dtf = (heads_first(t) for t in (x, b, c, dt))
    af = a.float()[None, :, None]
    tril = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    state = torch.zeros(bsz, h, p, b.shape[-1], dtype=torch.float32,
                        device=x.device)
    ys = []
    for ci in range(nc):
        rows = slice(ci * L, (ci + 1) * L)
        xc, bc, cc, dtc = xf[:, :, rows], bf[:, :, rows], cf[:, :, rows], (
            dtf[:, :, rows])
        cum = torch.cumsum(dtc * af, dim=-1)  # [B,H,L]
        total = cum[..., -1:]
        seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~tril, 0.0)
        decay = torch.where(tril, torch.exp(seg), 0.0)
        att = (cc @ bc.transpose(-1, -2)) * decay * dtc[..., None, :]
        y_in = (cc @ state.transpose(-1, -2)) * torch.exp(cum)[..., None]
        ys.append(att @ xc + y_in)
        w_in = (torch.exp(total - cum) * dtc)[..., None]  # [B,H,L,1]
        state = state * torch.exp(total)[..., None] + xc.transpose(-1, -2) @ (
            bc * w_in)
    y = torch.cat(ys, dim=2).transpose(1, 2)[:, :s]
    return y.to(x.dtype).contiguous(), state
