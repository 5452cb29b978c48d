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
them outside any Pallas kernel); there is no MoE kernel to port.

**On a mesh** (``moe_shard``, run by ``models.tensor_parallel`` on every
model shard of a data row) the router and its top-k run whole on every
shard, on replicas of the row's tokens, so every shard routes every token
bitwise alike. A shard then runs only its part of the experts: its own
experts ``[lo, lo + E/mp)`` where the rules split E over ``model`` (EP),
or every assignment over its slice of ``F`` (TP on F), and returns a
partial ``y`` in float32 that one ``all_reduce`` over ``model`` sums.
Under ``"drop"`` the capacity ranks are taken over all E experts, as on
one device, so the same assignments are dropped. The JAX package's
``moe_hints`` and ``moe_weight_gather`` ask GSPMD for the layout this tail
already has (``check_mesh_opts``).
"""

from __future__ import annotations

import torch

from repro_torch import perf
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


def _dispatch_batched(cfg: ArchConfig, p: dict, x: torch.Tensor,
                      lo: int = 0, partial: bool = False):
    """"drop": x [B, S, D] -> (y [B, S, D], expert indices, router
    probs). With ``partial`` (a mesh shard, ``moe_shard``) ``p`` holds
    experts ``[lo, lo + n)`` (or every expert's slice of F) and y is the
    shard's float32 part of the sum."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    n_loc = p["w_gate"].shape[0]
    cap = moe_capacity(cfg, s)
    gates, idx, probs = _route(cfg, p, x)  # [B,S,k], [B,S,E]

    n = s * k
    e_flat = idx.reshape(b, n)
    g_flat = gates.reshape(b, n)
    # position within expert: the running count of earlier same-expert
    # assignments (assignment i is token i // k's choice i % k), over all
    # E experts on a shard too, so that it drops what one device drops
    pos = torch.cumsum(_one_hot(e_flat, e), dim=1) - 1  # [B, N, E]
    pos_flat = pos.gather(2, e_flat[..., None])[..., 0]
    keep = pos_flat < cap
    if n_loc < e:  # another shard's expert: zeroed like a dropped row
        keep = keep & (e_flat >= lo) & (e_flat < lo + n_loc)
    pos_c = torch.where(keep, pos_flat, 0)
    e_c = torch.where(keep, e_flat - lo if lo else e_flat, 0)
    # slot (row, expert, position) of each assignment in the flat buffer
    slot = ((torch.arange(b, device=x.device)[:, None] * n_loc + e_c) * cap
            + pos_c).reshape(-1)

    rows_in = x[:, :, None, :].expand(b, s, k, d).reshape(b * n, d)
    rows_in = rows_in * keep.reshape(-1, 1).to(x.dtype)
    # an add, not a set: a dropped assignment (or another shard's) lands,
    # zeroed, on its row's slot (local expert 0, position 0), which may
    # hold a kept row; kept rows own distinct slots, so each slot is 0 +
    # its row (+ zeros), exact in any order of the adds
    buf = torch.zeros(b * n_loc * cap, d, dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, rows_in)
    out = _experts(cfg, p, buf.view(b, n_loc, cap, d), "becd,edf->becf",
                   "becf,efd->becd")

    rows_out = out.reshape(b * n_loc * cap, d)[slot].view(b, n, d)
    rows_out = rows_out * (g_flat * keep).to(out.dtype)[..., None]
    # token t's k rows are consecutive: the combine is a sum over k (a
    # shard sums the same rows, each in the model dtype, in float32)
    rows = rows_out.to(x.dtype).view(b, s, k, d)
    y = rows.float().sum(2) if partial else rows.sum(2)
    return y, idx, probs


def _dense_batched(cfg: ArchConfig, p: dict, x: torch.Tensor,
                   lo: int = 0, partial: bool = False):
    """"dense": every expert over every token, gate-weighted in float32
    (``partial`` as ``_dispatch_batched``: the shard's experts, or its F
    slice, and the float32 part of y)."""
    gates, idx, probs = _route(cfg, p, x)
    comb = torch.zeros(*x.shape[:2], cfg.num_experts, dtype=torch.float32,
                       device=x.device).scatter_(-1, idx, gates)
    n_loc = p["w_gate"].shape[0]
    if n_loc < cfg.num_experts:
        comb = comb[..., lo:lo + n_loc]
    out = _experts(cfg, p, x, "bsd,edf->besf", "besf,efd->besd")
    y = torch.einsum("besd,bse->bsd", out.float(), comb)
    return (y if partial else y.to(x.dtype)), idx, probs


def _gather_batched(cfg: ArchConfig, p: dict, x: torch.Tensor,
                    lo: int = 0, partial: bool = False):
    """"gather": the k chosen experts' weights per token ([B,S,k,D,F]
    reads, k·D·F instead of E·D·F), combined in float32. On a shard of
    experts ``[lo, lo + n)`` an id of another shard's expert reads the
    shard's first expert, with its gate zeroed."""
    gates, idx, probs = _route(cfg, p, x)  # [B,S,k]
    n_loc = p["w_gate"].shape[0]
    at = idx
    if n_loc < cfg.num_experts:
        mine = (idx >= lo) & (idx < lo + n_loc)
        at = torch.where(mine, idx - lo, 0)
        gates = torch.where(mine, gates, 0.0)
    w = {name: p[name][at] for name in ("w_gate", "w_up", "w_down")}
    out = _experts(cfg, w, x, "bsd,bskdf->bskf", "bskf,bskfd->bskd")
    y = torch.einsum("bskd,bsk->bsd", out.float(), gates)
    return (y if partial else y.to(x.dtype)), idx, probs


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


# ------------------------------------------------------------ on a mesh
def moe_split(specs: dict) -> str | None:
    """Where a mesh's specs (flat key -> spec, ``model`` entries read) put
    the experts: ``"experts"`` (E over ``model``, EP), ``"ffn"`` (F over
    ``model``, TP on F) or None (whole on every model shard, or no MoE)."""
    key = next((k for k in specs if k.endswith(".moe.w_gate")), None)
    if key is None:
        return None
    spec = tuple(specs[key])
    on = ["model" in ((e,) if isinstance(e, str) else tuple(e or ()))
          for e in spec]
    if on[-3]:
        return "experts"
    return "ffn" if on[-1] else None


def check_mesh_opts(cfg: ArchConfig, p: dict, split: str | None,
                    mp: int) -> None:
    """The readers of ``perf.moe_hints`` and ``perf.moe_weight_gather`` on
    a mesh shard whose MoE weights are ``p`` under ``split``. In the JAX
    package both are sharding constraints for GSPMD; the port lays every
    tensor out by hand, and in the layout each one asks for already:

    * ``moe_hints`` puts the dispatch buffer and the expert hidden state at
      "batch over data, experts over model" (experts unconstrained where
      ``model`` does not divide E). Each data row runs its own tokens, and
      a shard holds experts ``[lo, lo + E/mp)`` wherever the rules split E
      over ``model``, which they do wherever it divides;
    * ``moe_weight_gather`` gathers the expert weights over ``data`` at
      their use. The weights a shard computes with are whole over
      ``data``: ``fsdp.gather_params`` gathers every leaf (serving's
      ``MeshPlan.param_specs`` never split one over ``data``).

    So each flag selects nothing here, and this raises ``ValueError`` if
    the layout is ever another one than the flag asks for."""
    po = perf.current()
    e, d = cfg.num_experts, cfg.d_model
    if po.moe_hints and mp > 1 and e % mp == 0 and split != "experts":
        raise ValueError(
            f"moe_hints asks for the experts over 'model' ({e} experts, "
            f"model {mp}); this shard's layout is {split!r}")
    if po.moe_weight_gather and p["w_gate"].shape[-2] != d:
        raise ValueError(
            f"moe_weight_gather asks for expert weights whole over 'data' "
            f"at their use; w_gate is {tuple(p['w_gate'].shape)}")


def moe_shard(cfg: ArchConfig, p: dict, x: torch.Tensor, *, policy: str,
              lo: int = 0, partial: bool = True):
    """One model shard's part of the MoE tail: x [B,S,D] (the row's
    replica) -> (y, expert indices [B,S,k], router probs [B,S,E]). ``p``
    holds the shard's weights: experts ``[lo, lo + E/mp)`` (EP) or every
    expert's F slice (TP on F, ``lo`` 0), and y is then its float32 part of
    the sum over ``model``; with ``partial`` False (weights whole on every
    shard) y is one device's, in the model dtype."""
    if policy not in _POLICIES:
        raise ValueError(f"moe policy must be one of {POLICIES}, got {policy!r}")
    return _POLICIES[policy](cfg, p, x, lo, partial)


def aux_stats(cfg: ArchConfig, idx: torch.Tensor,
              probs: torch.Tensor) -> torch.Tensor:
    """The sums the aux term's means take, over a row's tokens: ``[2, E]``
    float32, router probabilities then assignment counts (``_aux_loss``
    before its division, so the rows' sums add up to the global batch's)."""
    e = cfg.num_experts
    me = probs.reshape(-1, e).sum(0)
    ce = _one_hot(idx, e).sum(-2).reshape(-1, e).float().sum(0)
    return torch.stack([me, ce])


def aux_from_stats(cfg: ArchConfig, stats: torch.Tensor,
                   tokens: int) -> torch.Tensor:
    """The aux term summed over layers from the global batch's sums
    ``stats`` ``[L, 2, E]`` (``aux_stats`` summed over every row) of
    ``tokens`` tokens: each layer's ``Σ me·ce · E/k`` with the means of the
    whole batch, as one device takes them."""
    me, ce = stats[:, 0] / tokens, stats[:, 1] / tokens
    return ((me * ce).sum(-1) * (cfg.num_experts / cfg.top_k)).sum()
