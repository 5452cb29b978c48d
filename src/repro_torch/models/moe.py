"""Top-k mixture of experts with three semi-static dispatch policies
(counterpart of ``repro.models.moe``, inference only).

Per sequence, the S·k assignments of the router's top-k are dispatched one
of three ways, each a semi-static branch baked into a serving target when it
is built (``EngineConfig.moe_policy``; DESIGN.md §2):

* ``"drop"`` (the default) — capacity-bounded: each assignment gets its rank
  within its expert by a running count over the sequence (a one-hot
  cumsum), the first ``moe_capacity(cfg, S)`` of an expert are scattered
  into a fixed ``[B, E, C, D]`` buffer and the rest dropped (the residual
  stream carries a dropped token, Switch-Transformer semantics), every
  expert runs over its buffer, and the kept rows come back gate-weighted;
* ``"dense"`` — every expert over every token, combined by a gate matrix
  that is zero off the top-k: nothing is dropped;
* ``"gather"`` — the k chosen experts' weights gathered per token and
  applied directly: nothing is dropped, and only k of E experts' weights
  are read (the decode-oriented branch).

Capacity follows the call's own length S (the padded chunk bucket, the
verify window, 1 for a decode step), so under ``"drop"`` a chunked prefill
or a verify pass can drop assignments that token-by-token decode keeps, as
in the JAX package.

Everything is static-shaped and free of host synchronisation (no boolean
indexing, ``nonzero`` or ``.item()``), so each policy captures into a CUDA
graph. The expert products are ``torch.einsum`` (the JAX package computes
them outside any Pallas kernel); there is no MoE kernel to port. The sharding
hints of the JAX version act only on a mesh and are left out
(``perf.UNREAD``).
"""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig

from .mlp import _act


def moe_capacity(cfg: ArchConfig, seq: int) -> int:
    """Slots per expert for a call of ``seq`` tokens a row."""
    cap = int(cfg.capacity_factor * seq * cfg.top_k / cfg.num_experts)
    return max(cap, cfg.top_k)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, equal values in index order (as
    ``jax.lax.top_k`` orders them; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """x: [..., S, D] -> gates [..., S, k] (renormalised, float32), expert
    indices [..., S, k] (int64), probs [..., S, E] (float32). The router
    runs in float32 whatever the model dtype."""
    logits = torch.einsum("...sd,de->...se", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, cfg.top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    return gates, idx, probs


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int32 one-hot of ``idx`` over ``n`` classes (a compare, no sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.int32)


def _aux_loss(cfg: ArchConfig, idx: torch.Tensor,
              probs: torch.Tensor) -> torch.Tensor:
    """The load-balancing term: mean router probability times mean
    assignment count per expert, summed, times E / k."""
    e = cfg.num_experts
    me = probs.mean(dim=tuple(range(probs.dim() - 1)))  # [E]
    ce = _one_hot(idx, e).sum(-2).float().mean(dim=tuple(range(idx.dim() - 1)))
    return (me * ce).sum() * (e / cfg.top_k)


def _experts(cfg: ArchConfig, p: dict, buf: torch.Tensor,
             spec_in: str, spec_out: str) -> torch.Tensor:
    """The gated expert MLP over ``buf`` in the einsum layout ``spec_in``
    (rows of each expert) -> ``spec_out``, in the buffer's dtype."""
    h = _act(cfg.act, torch.einsum(spec_in, buf, p["w_gate"]))
    h = h * torch.einsum(spec_in, buf, p["w_up"])
    return torch.einsum(spec_out, h, p["w_down"])


def _dispatch_batched(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """"drop": x [B, S, D] -> (y [B, S, D], expert indices, router
    probs)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = moe_capacity(cfg, s)
    gates, idx, probs = _route(cfg, p, x)  # [B,S,k], [B,S,E]

    n = s * k
    e_flat = idx.reshape(b, n)
    g_flat = gates.reshape(b, n)
    # position within expert: the running count of earlier same-expert
    # assignments (assignment i is token i // k's choice i % k)
    pos = torch.cumsum(_one_hot(e_flat, e), dim=1) - 1  # [B, N, E]
    pos_flat = pos.gather(2, e_flat[..., None])[..., 0]
    keep = pos_flat < cap
    pos_c = torch.where(keep, pos_flat, 0)
    e_c = torch.where(keep, e_flat, 0)
    # slot (row, expert, position) of each assignment in the flat buffer
    slot = ((torch.arange(b, device=x.device)[:, None] * e + e_c) * cap
            + pos_c).reshape(-1)

    rows_in = x[:, :, None, :].expand(b, s, k, d).reshape(b * n, d)
    rows_in = rows_in * keep.reshape(-1, 1).to(x.dtype)
    # an add, not a set: a dropped assignment lands, zeroed, on its row's
    # slot (expert 0, position 0), which may hold a kept row; kept rows own
    # distinct slots, so each slot is 0 + its row (+ zeros), exact in any
    # order of the adds
    buf = torch.zeros(b * e * cap, d, dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, rows_in)
    out = _experts(cfg, p, buf.view(b, e, cap, d), "becd,edf->becf",
                   "becf,efd->becd")

    rows_out = out.reshape(b * e * cap, d)[slot].view(b, n, d)
    rows_out = rows_out * (g_flat * keep).to(out.dtype)[..., None]
    # token t's k rows are consecutive: the combine is a sum over k
    y = rows_out.to(x.dtype).view(b, s, k, d).sum(2)
    return y, idx, probs


def _dense_batched(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """"dense": every expert over every token, gate-weighted in float32."""
    gates, idx, probs = _route(cfg, p, x)
    comb = torch.zeros(*x.shape[:2], cfg.num_experts, dtype=torch.float32,
                       device=x.device).scatter_(-1, idx, gates)
    out = _experts(cfg, p, x, "bsd,edf->besf", "besf,efd->besd")
    y = torch.einsum("besd,bse->bsd", out.float(), comb).to(x.dtype)
    return y, idx, probs


def _gather_batched(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """"gather": the k chosen experts' weights per token ([B,S,k,D,F]
    reads, k·D·F instead of E·D·F), combined in float32."""
    gates, idx, probs = _route(cfg, p, x)  # [B,S,k]
    w = {name: p[name][idx] for name in ("w_gate", "w_up", "w_down")}
    out = _experts(cfg, w, x, "bsd,bskdf->bskf", "bskf,bskfd->bskd")
    y = torch.einsum("bskd,bsk->bsd", out.float(), gates).to(x.dtype)
    return y, idx, probs


_POLICIES = {
    "drop": _dispatch_batched,
    "dense": _dense_batched,
    "gather": _gather_batched,
}
POLICIES = tuple(_POLICIES)


def moe_apply(
    cfg: ArchConfig, p: dict, x: torch.Tensor, *, policy: str = "drop",
    with_aux: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x: [B,S,D] -> (y [B,S,D], aux float32 scalar); ``p`` is one layer's
    ``{"router": [D,E] float32, "w_gate"/"w_up": [E,D,F], "w_down":
    [E,F,D]}``. The serving steps pass ``with_aux=False`` and get None for
    the aux term, whose kernels they would discard (the JAX package's
    compiled steps drop it as dead code)."""
    if policy not in _POLICIES:
        raise ValueError(f"moe policy must be one of {POLICIES}, got {policy!r}")
    y, idx, probs = _POLICIES[policy](cfg, p, x)
    return y, (_aux_loss(cfg, idx, probs) if with_aux else None)
