"""Gradient compression for the trainer and the collectives over a logical
mesh: the port's copy of ``repro.distributed.collectives``.

``quantize_tree`` / ``dequantize_tree`` are int8 quantisation with one
float32 scale per leaf; ``make_grad_compressor`` is the trainer's
``grad_compress`` hook (int8 or bf16, with an error-feedback residual so
repeated compression does not bias the optimiser). ``all_reduce``,
``all_gather``, ``reduce_scatter``, ``ppermute``, ``pmax`` and
``compressed_psum`` (an int8 all-reduce) run over one axis of a
``sharding.LogicalMesh``, on a mapping from mesh coordinate to shard: the
port's counterparts of ``lax.psum``, ``lax.all_gather``,
``lax.psum_scatter``, ``lax.ppermute`` and ``lax.pmax`` inside
``shard_map``.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch

from repro_torch.capture_analysis import collective


def _qparams(x: torch.Tensor) -> torch.Tensor:
    amax = torch.max(torch.abs(x))
    return torch.clamp(amax, min=1e-12) / 127.0


def _quantize(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Round half to even, as ``jnp.round``, into [-127, 127]."""
    return torch.clip(torch.round(x / s), -127, 127).to(torch.int8)


def quantize_tree(tree: dict) -> tuple[dict, dict]:
    """-> (int8 dict, float32 scale dict)."""
    qs, ss = {}, {}
    for k, x in tree.items():
        xf = x.to(torch.float32)
        ss[k] = _qparams(xf)
        qs[k] = _quantize(xf, ss[k])
    return qs, ss


def dequantize_tree(qs: dict, ss: dict) -> dict:
    return {k: q.to(torch.float32) * ss[k] for k, q in qs.items()}


def make_grad_compressor(
    bits: int = 8, error_feedback: bool = True
) -> tuple[Callable, Callable]:
    """Returns (compress_fn, init_residual_fn) for the trainer hook.

    compress_fn(grads, residual) -> (grads_hat, new_residual): quantises the
    gradient (plus carried residual) and keeps the quantisation error for
    the next step. With error_feedback=False the residual stays zero."""
    if bits not in (8, 16):
        raise ValueError(f"bits must be 8 or 16, got {bits}")

    def init_residual(grads: dict) -> dict:
        return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for k, g in grads.items()}

    def compress(grads: dict, residual: dict) -> tuple[dict, dict]:
        ghat, new_r = {}, {}
        for k, g in grads.items():
            gf = g.to(torch.float32) + residual[k]
            if bits == 16:
                h = gf.to(torch.bfloat16).to(torch.float32)
            else:
                s = _qparams(gf)
                h = _quantize(gf, s).to(torch.float32) * s
            new_r[k] = gf - h if error_feedback else torch.zeros_like(gf)
            ghat[k] = h.to(g.dtype)
        return ghat, new_r

    return compress, init_residual


# ------------------------------------------------- collectives over a mesh
# Each takes and returns a mapping from mesh coordinate to tensor (the
# shards of one logical array); ``axis`` names the mesh axis the collective
# runs over, so coordinates that differ only there form one group. Every
# result is computed once per group in a fixed order of coordinates (so it
# does not depend on which device asks) and moved to each member's device
# with ``.to(device)``: on one card the members share one tensor. A mesh of
# ``meta`` devices (the dry run) stands for distinct cards, so there each
# member gets its own copy (free on ``meta``: nothing is allocated), as
# each card would hold one. Under a capture report (``capture_analysis``)
# each counts its result's bytes per coordinate under the JAX package's op
# type (``pmax`` is an all-reduce). Where a result takes a gradient (the
# mesh train step) the backward runs the transposed collective, counted
# too: ``all_reduce``'s is an ``all_reduce`` of the members' gradients, a
# tiled ``all_gather``'s a ``reduce_scatter``.
def _groups(xs: Mapping[tuple, torch.Tensor], mesh,
            axis: str) -> list[list[tuple]]:
    """``xs``'s coordinates grouped by every axis but ``axis``, each group
    in ascending order along ``axis``."""
    a = mesh.axis(axis)
    groups: dict[tuple, list[tuple]] = {}
    for c in sorted(xs):
        groups.setdefault(c[:a] + c[a + 1:], []).append(c)
    return list(groups.values())


def _member(value: torch.Tensor, mesh, c: tuple, i: int) -> torch.Tensor:
    if i and value.device.type == "meta":
        return value.clone()
    return value.to(mesh.device(c))


def _spread(group: list[tuple], value: torch.Tensor, mesh) -> dict:
    return {c: _member(value, mesh, c, i) for i, c in enumerate(group)}


class _Fanout(torch.autograd.Function):
    """A collective's result handed to every member of its group, whose
    backward is the transposed collective: the members' gradients summed by
    ``all_reduce`` (the result of an ``all_reduce``) or by
    ``reduce_scatter`` along ``dim`` and joined (the result of a tiled
    ``all_gather``), so a capture report counts the backward pass's
    collectives as the JAX package's per-device program holds them."""

    @staticmethod
    def forward(ctx, value, mesh, axis, group, dim):
        ctx.mesh, ctx.axis, ctx.group, ctx.dim = mesh, axis, group, dim
        ctx.device = value.device
        return tuple(value.view_as(value) if m is value else m
                     for m in (_member(value, mesh, c, i)
                               for i, c in enumerate(group)))

    @staticmethod
    def backward(ctx, *grads):
        gs = dict(zip(ctx.group, grads))
        first = ctx.group[0]
        if ctx.dim is None:
            total = all_reduce(gs, ctx.mesh, ctx.axis)[first]
        else:
            parts = reduce_scatter(gs, ctx.mesh, ctx.axis, dim=ctx.dim)
            dev = parts[first].device
            total = torch.cat([parts[c].to(dev) for c in ctx.group], ctx.dim)
        return total.to(ctx.device), None, None, None, None


def _fan(group: list[tuple], value: torch.Tensor, mesh, axis: str,
         dim: int | None = None) -> dict:
    """``_spread``, differentiable with the transposed collective where
    the result takes a gradient."""
    if not (torch.is_grad_enabled() and value.requires_grad):
        return _spread(group, value, mesh)
    return dict(zip(group, _Fanout.apply(value, mesh, axis, group, dim)))


@collective("all-reduce")
def all_reduce(xs: Mapping[tuple, torch.Tensor], mesh,
               axis: str) -> dict:
    """The sum over ``axis`` (``lax.psum``), accumulated in the shards'
    dtype in ascending coordinate order."""
    out: dict = {}
    for group in _groups(xs, mesh, axis):
        dev = mesh.device(group[0])
        acc = xs[group[0]]
        for c in group[1:]:
            acc = acc + xs[c].to(dev)
        out.update(_fan(group, acc, mesh, axis))
    return out


@collective("all-reduce")
def pmax(xs: Mapping[tuple, torch.Tensor], mesh, axis: str) -> dict:
    """The elementwise maximum over ``axis`` (``lax.pmax``)."""
    out: dict = {}
    for group in _groups(xs, mesh, axis):
        dev = mesh.device(group[0])
        acc = xs[group[0]]
        for c in group[1:]:
            acc = torch.maximum(acc, xs[c].to(dev))
        out.update(_spread(group, acc, mesh))
    return out


@collective("all-gather")
def all_gather(xs: Mapping[tuple, torch.Tensor], mesh, axis: str, *,
               dim: int = 0, tiled: bool = False) -> dict:
    """Every shard along ``axis``, in order (``lax.all_gather``): stacked
    on a new axis ``dim``, or with ``tiled`` concatenated along ``dim``."""
    out: dict = {}
    for group in _groups(xs, mesh, axis):
        dev = mesh.device(group[0])
        parts = [xs[c].to(dev) for c in group]
        if tiled:
            out.update(_fan(group, torch.cat(parts, dim), mesh, axis, dim))
        else:
            out.update(_spread(group, torch.stack(parts, dim), mesh))
    return out


@collective("reduce-scatter")
def reduce_scatter(xs: Mapping[tuple, torch.Tensor], mesh, axis: str, *,
                   dim: int = 0) -> dict:
    """The sum over ``axis``, of which each coordinate keeps its slice
    along ``dim`` (``lax.psum_scatter`` with ``tiled=True``): the member at
    index ``i`` along ``axis`` gets chunk ``i`` of ``n``, summed in the
    shards' dtype in ascending coordinate order, as ``all_reduce``."""
    a = mesh.axis(axis)
    n = mesh.shape[axis]
    out: dict = {}
    for group in _groups(xs, mesh, axis):
        dev = mesh.device(group[0])
        acc = xs[group[0]]
        for c in group[1:]:
            acc = acc + xs[c].to(dev)
        size = acc.shape[dim]
        if size % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {size} does not "
                             f"divide over the {n} members of {axis!r}")
        step = size // n
        for c in group:
            out[c] = acc.narrow(dim, c[a] * step, step).to(
                mesh.device(c), copy=True)
    return out


@collective("collective-permute")
def ppermute(xs: Mapping[tuple, torch.Tensor], mesh, axis: str,
             perm: Sequence[tuple[int, int]]) -> dict:
    """``lax.ppermute``: the shard at index ``src`` along ``axis`` moves to
    index ``dst`` for every ``(src, dst)`` of ``perm``; a coordinate that
    receives nothing gets zeros."""
    a = mesh.axis(axis)
    dst_of = dict(perm)
    out = {c: torch.zeros_like(x) for c, x in xs.items()}
    for c, x in xs.items():
        if c[a] in dst_of:
            to = c[:a] + (dst_of[c[a]],) + c[a + 1:]
            if to in out:
                out[to] = x.to(mesh.device(to))
    return out


def compressed_psum(xs: Mapping[tuple, torch.Tensor], mesh,
                    axis: str) -> dict:
    """int8-on-the-wire all-reduce (``repro.distributed.collectives``'s
    ``compressed_psum``): each shard's absmax scale, their ``pmax``, each
    shard quantised to int8 at that shared scale, an ``all_gather`` of the
    int8 shards (the moved tensors really are int8: a quarter of an f32
    all-reduce's bytes), and an f32 sum of them times the scale. Right-sized
    for a small axis (2-8 shards)."""
    scales = pmax({c: _qparams(x.to(torch.float32)) for c, x in xs.items()},
                  mesh, axis)
    qs = {c: _quantize(x.to(torch.float32), scales[c])
          for c, x in xs.items()}
    gathered = all_gather(qs, mesh, axis)  # int8 on the wire
    return {c: torch.sum(g.to(torch.float32), dim=0) * scales[c]
            for c, g in gathered.items()}
