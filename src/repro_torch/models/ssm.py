"""Mamba-2 SSD (state-space duality) mixer: chunked scan + O(1)-state decode
(counterpart of ``repro.models.ssm``, arXiv:2405.21060 §6).

  * within a chunk of length L: dense "attention-like" semiseparable matmul
  * across chunks: recurrent state [B, H, P, N] carried in a loop

``ssm_apply`` runs the scan through kernel B8 (``kernels.ssd_chunk``) with
``impl="kernel"`` and through the plain ``ssd_scan`` otherwise. Decode is a
single recurrence step: h <- h·exp(dt·A) + dt·B⊗x ; y = C·h + D·x. The
conv1d (k=4, depthwise, causal) keeps a rolling [B, k-1, chans] window of its
*pre-conv* inputs. ``ssm_decode_step`` updates the layer's cache in place
(the port's caches are views of the stacked ``[m, ...]`` tensors).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.configs import ArchConfig

from .layers import dtype_of, rms_norm


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in the model dtype. x: [B,S,C]; w: [K,C]. The
    JAX package's pad and K shifted multiply-adds (not ``F.conv1d``, whose
    float32 path runs through cuDNN in TF32 by default)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i : i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    return F.silu(out)


def _proj_inputs(p: dict, x: torch.Tensor):
    """x: [B,S,D] -> z, xBC (pre-conv), dt (raw)."""
    z = x @ p["wz"]
    xbc = torch.cat([x @ p["wx"], x @ p["wB"], x @ p["wC"]], dim=-1)
    return z, xbc, x @ p["wdt"]


def _split_xbc(cfg: ArchConfig, xbc: torch.Tensor):
    """[B,S,din+2GN] -> x [B,S,H,P], B [B,S,G,N], C [B,S,G,N] (views)."""
    din = cfg.ssm_d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    b, s = xbc.shape[:2]
    xh = xbc[..., :din].reshape(b, s, cfg.ssm_heads, cfg.ssm_headdim)
    bg = xbc[..., din : din + gn].reshape(b, s, cfg.ssm_groups, cfg.ssm_state)
    cg = xbc[..., din + gn :].reshape(b, s, cfg.ssm_groups, cfg.ssm_state)
    return xh, bg, cg


def _expand_groups(cfg: ArchConfig, t: torch.Tensor) -> torch.Tensor:
    """[B,S,G,N] -> [B,S,H,N], group g serving heads g·H/G .. (g+1)·H/G-1
    (``jnp.repeat`` over heads). One group is a stride-0 view, no copy."""
    if cfg.ssm_groups == 1:
        return t.expand(*t.shape[:2], cfg.ssm_heads, t.shape[-1])
    return t.repeat_interleave(cfg.ssm_heads // cfg.ssm_groups, dim=2)


def ssd_scan(
    cfg: ArchConfig,
    xh: torch.Tensor,  # [B,S,H,P]
    bg: torch.Tensor,  # [B,S,H,N] (group-expanded)
    cg: torch.Tensor,  # [B,S,H,N]
    dt: torch.Tensor,  # [B,S,H] (post-softplus)
    A: torch.Tensor,  # [H] (negative)
    h0: torch.Tensor | None = None,  # [B,H,P,N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain chunked SSD, the oracle. Returns (y [B,S,H,P] in x's dtype,
    h_final [B,H,P,N] float32)."""
    b, s, H, P = xh.shape
    n = bg.shape[-1]
    L = min(cfg.ssm_chunk, s)
    s_orig = s
    if s % L:
        # pad to a chunk multiple with dt=0 positions: zero dt => decay 1 and
        # zero input contribution, so the carried state is unaffected.
        pad = L - s % L
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        bg = F.pad(bg, (0, 0, 0, 0, 0, pad))
        cg = F.pad(cg, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        s = s + pad
    nc = s // L

    def chunk(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(b, nc, L, *t.shape[2:]).float()

    xc, bc, cc, dtc = chunk(xh), chunk(bg), chunk(cg), chunk(dt)

    da = dtc * A[None, None, None, :]  # [B,nc,L,H] log-decay per step
    cum = torch.cumsum(da, dim=2)  # within-chunk cumulative
    total = cum[:, :, -1, :]  # [B,nc,H]

    # intra-chunk: y[l] = sum_{l'<=l} C[l]·B[l'] exp(cum[l]-cum[l']) dt[l'] x[l']
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,L,L',H]
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=xh.device))
    decay = torch.where(mask[None, None, :, :, None], torch.exp(seg), 0.0)
    cb = torch.einsum("bclhn,bcmhn->bclmh", cc, bc)  # [B,nc,L,L',H]
    att = cb * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", att, xc)

    # chunk-boundary states: S_c = sum_l exp(total - cum[l]) dt[l] B[l] x[l]
    w_in = torch.exp(total[:, :, None, :] - cum) * dtc  # [B,nc,L,H]
    s_chunk = torch.einsum("bclh,bclhn,bclhp->bchpn", w_in, bc, xc)

    h = torch.zeros(b, H, P, n, dtype=torch.float32, device=xh.device)
    if h0 is not None:
        h = h0.float()
    y_inter = []
    for ci in range(nc):
        # contribution of the incoming state to every position in this chunk
        y_inter.append(torch.einsum(
            "blhn,bhpn,blh->blhp", cc[:, ci], h, torch.exp(cum[:, ci])
        ))
        h = h * torch.exp(total[:, ci])[..., None, None] + s_chunk[:, ci]
    y = y_intra + torch.stack(y_inter, dim=1)
    y = y.reshape(b, s, H, P)[:, :s_orig]
    return y.to(xh.dtype), h


def ssm_apply(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,
    h0: torch.Tensor | None = None,
    *,
    return_cache: bool = False,
    impl: str = "kernel",
):
    """Full-sequence Mamba2 mixer. x: [B,S,D] -> (y [B,S,D], h_final |
    cache). ``impl="kernel"`` scans with B8 (no initial state: ``h0``
    raises), anything else with ``ssd_scan``."""
    z, xbc_pre, dt_raw = _proj_inputs(p, x)
    xbc = _causal_conv(xbc_pre, p["conv"])
    xh, bg, cg = _split_xbc(cfg, xbc)
    bgh = _expand_groups(cfg, bg)
    cgh = _expand_groups(cfg, cg)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if impl == "kernel":
        if h0 is not None:
            raise ValueError(
                "ssm_apply: kernel B8 starts from a zero state; an initial "
                "state h0 needs impl='naive' or 'chunked' (ssd_scan)"
            )
        y, h_final = kernels.ssd_chunk(xh, bgh, cgh, dt, A,
                                       chunk=cfg.ssm_chunk)
    else:
        y, h_final = ssd_scan(cfg, xh, bgh, cgh, dt, A, h0)
    y = y + xh * p["D"].to(xh.dtype)[None, None, :, None]
    b, s = x.shape[:2]
    y = y.reshape(b, s, cfg.ssm_d_inner)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm_scale"],
                 cfg.norm_eps)
    out = y @ p["out"]
    if return_cache:
        cache = {
            "conv": xbc_pre[:, -(cfg.conv_kernel - 1) :, :],
            "state": h_final,
        }
        return out, cache
    return out, h_final


# -------------------------------------------------------------------- decode
def init_ssm_cache(
    cfg: ArchConfig, batch: int, device: torch.device | str = "cpu"
) -> dict:
    gn = cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros(
            (batch, cfg.conv_kernel - 1, cfg.ssm_d_inner + 2 * gn),
            dtype=dtype_of(cfg), device=device,
        ),
        "state": torch.zeros(
            (batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
            dtype=torch.float32, device=device,
        ),
    }


def ssm_decode_step(
    cfg: ArchConfig, p: dict, x: torch.Tensor, cache: dict
) -> tuple[torch.Tensor, dict]:
    """One token. x: [B,1,D] -> (y [B,1,D], cache). The new conv window and
    state are written in place into ``cache``'s tensors."""
    z, xbc, dt_raw = _proj_inputs(p, x)  # [B,1,*]
    window = torch.cat([cache["conv"], xbc], dim=1)  # [B,K,C]
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv"])[:, None, :]
    xbc1 = F.silu(conv_out)
    xh, bg, cg = _split_xbc(cfg, xbc1)
    bgh = _expand_groups(cfg, bg)[:, 0]  # [B,H,N]
    cgh = _expand_groups(cfg, cg)[:, 0]
    xh1 = xh[:, 0].float()  # [B,H,P]
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])  # [B,H]
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A[None, :])  # [B,H]
    h = cache["state"] * decay[:, :, None, None] + torch.einsum(
        "bh,bhn,bhp->bhpn", dt, bgh.float(), xh1
    )
    y = torch.einsum("bhn,bhpn->bhp", cgh.float(), h)
    y = y + xh1 * p["D"][None, :, None]
    y = y.reshape(x.shape[0], 1, cfg.ssm_d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm_scale"],
                 cfg.norm_eps)
    cache["conv"].copy_(window[:, 1:, :])
    cache["state"].copy_(h)
    return y @ p["out"], cache
