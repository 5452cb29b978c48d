"""GPipe-style pipeline parallelism over a "stage" axis of a logical mesh:
the port's copy of ``repro.distributed.pipeline`` (DESIGN.md §5).

The layer stack is split into ``num_stages`` contiguous groups; microbatches
stream through the stages, stage ``s`` on the mesh's device ``s``, each
boundary transfer a ``collectives.ppermute``. The schedule is the classic
GPipe fill/steady/drain: T = M + S - 1 ticks for M microbatches over S
stages, bubble fraction (S - 1) / (M + S - 1). The JAX package runs one
``shard_map`` body per device; here one process runs every stage's body of
a tick in stage order, which is the same arithmetic on the same operands.

Scope: forward pipelining (inference, activation streaming), as in the JAX
package; any ``stage_fn(stage_params, x) -> x`` works.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import collectives


def split_stages(cfg, num_stages: int) -> int:
    """Layers per stage (in period groups); requires an even split."""
    m = cfg.num_layers // cfg.period
    if m % num_stages:
        raise ValueError(
            f"{cfg.name}: {m} period-groups not divisible by {num_stages} "
            f"stages")
    return m // num_stages


def pipeline_forward(
    stage_fn: Callable,
    params_stacked: dict,
    x_microbatches: torch.Tensor,
    *,
    mesh,
    stage_axis: str = "stage",
) -> torch.Tensor:
    """Run M microbatches ``[M, mb, ...]`` through S stages (GPipe).

    ``params_stacked`` holds stage-major leaves ``[S, ...]``; stage ``s``'s
    slice and its activations live on the device at index ``s`` of
    ``stage_axis`` (``mesh`` a one-axis ``LogicalMesh``). At tick ``t``
    stage 0 takes microbatch ``t`` (zeros once they run out), every other
    stage the activation its predecessor passed at ``t - 1``; the last
    stage's output at tick ``t`` is microbatch ``t - (S - 1)``. The outputs
    ``[M, mb, ...]`` are summed over the stage axis from the last stage
    (the others contribute zeros), as the JAX package broadcasts them, and
    returned on the first stage's device."""
    if mesh.axis_names != (stage_axis,):
        raise ValueError(f"pipeline_forward runs over a one-axis mesh "
                         f"({stage_axis!r},), got {mesh.axis_names}")
    num_stages = mesh.shape[stage_axis]
    m_total = x_microbatches.shape[0]
    coords = mesh.coords()
    stage_params = {
        c: {k: t[c[0]].to(mesh.device(c)) for k, t in params_stacked.items()}
        for c in coords
    }
    xs = x_microbatches.to(mesh.device(coords[0]))
    mb_shape = tuple(xs.shape[1:])
    buf = {c: torch.zeros(mb_shape, dtype=xs.dtype, device=mesh.device(c))
           for c in coords}
    outs = {c: torch.zeros_like(xs, device=mesh.device(c)) for c in coords}
    hop = [(i, (i + 1) % num_stages) for i in range(num_stages)]
    last = coords[-1]
    for t in range(m_total + num_stages - 1):
        ys = {}
        for c in coords:
            if c[0] == 0:
                x_in = (xs[t] if t < m_total
                        else torch.zeros(mb_shape, dtype=xs.dtype,
                                         device=xs.device))
            else:
                x_in = buf[c]
            ys[c] = stage_fn(stage_params[c], x_in)
        out_idx = t - (num_stages - 1)
        if 0 <= out_idx < m_total:
            outs[last][out_idx] = ys[last]
        buf = collectives.ppermute(ys, mesh, stage_axis, hop)
    return collectives.all_reduce(outs, mesh, stage_axis)[coords[0]]


def reference_forward(stage_fn: Callable, params_stacked: dict,
                      x_microbatches: torch.Tensor) -> torch.Tensor:
    """Sequential oracle: every stage applied in order to every
    microbatch, no pipelining."""
    s = next(iter(params_stacked.values())).shape[0]
    outs = []
    for x in x_microbatches:
        for i in range(s):
            x = stage_fn({k: t[i] for k, t in params_stacked.items()}, x)
        outs.append(x)
    return torch.stack(outs)


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
