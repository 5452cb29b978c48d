"""The train state on a mesh of logical devices: FSDP over ``data``,
tensor parallelism over ``model`` (ROADMAP A12 part 3 item 4; the JAX
package's ``train_shardings`` / ``place_train_state``, DESIGN.md §5-§6).

**The state.** A ``ShardedTrainState`` holds every leaf of a
``TrainState`` as its pieces, one per mesh coordinate (``{coord: tensor}``):
the params by ``sharding.param_pspec_tree`` (the full rules: FSDP over
``data`` included, not ``MeshPlan.param_specs``' TP-only ones), the AdamW
moments by ``opt_pspec_tree`` and the step replicated. Every piece owns
its storage (``sharding.shard`` copies), also where one card or the CPU is
named at several coordinates: the update runs in place on each
coordinate's pieces, so replicas that shared one tensor would be stepped
once per coordinate.

**At use** (``gather_params``) each coordinate gathers its model shard of
every leaf over ``data``: the layout ``use_specs`` gives (the rules with
``data`` and ``pod`` stripped), which ``models.spmd`` runs the tower on.
A dim split over ``("data", "model")`` together (a vocab that ``model``
does not divide puts the table's ``d_model`` there: granite's 49155
entries) holds chunk ``i_data·|model| + i_model`` at ``(d, m)``, data
major (``sharding.shard_slices``). At a fixed ``m`` the data pieces are
then the strided chunks ``m, mp+m, 2mp+m, ...``, not the contiguous model
block ``m`` the use layout needs, so such a dim is gathered whole over
both axes and each coordinate takes its block.

**Gradients** (``reduce_grads``). A coordinate's autograd gradient of its
gathered weight is its part of the sum over every use of the weight:

* a leaf the spec leaves whole over ``model`` is one variable that every
  model shard of a row used, so its shards' partial gradients are
  ``all_reduce``d over ``model``;
* then the data rows' parts are summed: a leaf split over ``data`` keeps
  its slice (``reduce_scatter``), any other is ``all_reduce``d; a dim over
  ``("data", "model")`` is ``all_reduce``d over ``data``, its model blocks
  joined over ``model`` (``all_gather``) and each coordinate keeps its
  chunk;
* the ``pod`` axis holds replicas of the params: ``all_reduce``, or under
  ZeRO over ``pod`` (below) ``reduce_scatter`` onto the moments' slices.

**The update** (``apply_adamw``) is ``optim.adamw.update`` on each
coordinate's pieces, with the global norm of the whole gradient: each
distinct piece's squared sum is added once (the coordinate at index 0 of
every axis its spec leaves whole holds it), and the per-coordinate sums are
``all_reduce``d over every axis, so every replica clips by the same scale
and stays equal bit for bit.

**ZeRO over ``pod``** (``cfg.zero_over_pod``: grok, jamba) splits a
moment finer than its param: the first data dim takes ``pod`` as its minor
axis (``sharding.opt_pspec_tree``), so the moment at pod index ``p`` is
sub-block ``p`` of the param piece along that dim. The gradient is
reduce-scattered over ``pod`` onto that sub-block, the update steps the
sub-block of the param, and the updated sub-blocks are gathered over
``pod`` back into every replica of the piece, which so stay equal bit for
bit. The global norm counts such a gradient by the moment's spec: each
sub-block once.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import torch

from repro_torch.convert import leaf_order
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.optim import adamw

BATCH_AXES = ("pod", "data")


class ShardedTrainState(NamedTuple):
    """A ``TrainState`` held as pieces: ``params`` and ``opt.mu``/``opt.nu``
    map each key to ``{coord: piece}``, ``opt.step`` is ``{coord: i32}``;
    ``specs`` = (param specs, moment specs) and ``mesh`` the mesh."""

    params: dict
    opt: adamw.AdamWState
    specs: tuple
    mesh: Any


def state_specs(cfg, params_shape: Mapping[str, Any], mesh) -> tuple:
    """(param specs, moment specs) of a state on ``mesh`` by the rules. A
    moment's spec is its param's, or under ZeRO over ``pod`` its param's
    with ``pod`` the minor axis of one data dim (``zero_dim``); a param
    spec that splits over ``pod`` is refused (the rules make none)."""
    p_spec = shd.param_pspec_tree(params_shape, mesh)
    mu_spec = shd.opt_pspec_tree(cfg, p_spec, params_shape, mesh)
    for k, s in mu_spec.items():
        if shd.splits(p_spec[k], "pod") or (
                s != p_spec[k] and zero_dim(p_spec[k], s) is None):
            raise ValueError(f"{k}: moments {s} are not params {p_spec[k]} "
                             f"or a split of them over 'pod'")
    return p_spec, mu_spec


def zero_dim(p_spec: tuple, mu_spec: tuple) -> int | None:
    """The dim a moment splits finer than its param (its param's axes then
    ``pod``), None where the two specs are equal."""
    for j, (a, b) in enumerate(zip(p_spec, mu_spec)):
        if a != b:
            return (j if shd.spec_axes(b) == shd.spec_axes(a) + ("pod",)
                    else None)
    return None


def shard_state(cfg, state, mesh) -> ShardedTrainState:
    """``state`` (a ``TrainState`` on any device, ``meta`` too) split into
    every coordinate's pieces, each a copy on its coordinate's device."""
    p_spec, mu_spec = state_specs(cfg, state.params, mesh)
    step = {c: state.opt.step.to(mesh.device(c), copy=True)
            for c in mesh.coords()}
    return ShardedTrainState(
        params={k: shd.shard(t, p_spec[k], mesh)
                for k, t in state.params.items()},
        opt=adamw.AdamWState(
            step=step,
            mu={k: shd.shard(t, mu_spec[k], mesh)
                for k, t in state.opt.mu.items()},
            nu={k: shd.shard(t, mu_spec[k], mesh)
                for k, t in state.opt.nu.items()}),
        specs=(p_spec, mu_spec), mesh=mesh)


def unshard_state(state: ShardedTrainState, device=None):
    """The global ``TrainState`` joined back from the pieces, on ``device``
    (default the first coordinate's)."""
    from repro_torch.runtime.steps import TrainState

    mesh = state.mesh
    p_spec, mu_spec = state.specs
    first = mesh.coords()[0]
    dev = device if device is not None else mesh.device(first)

    def join(tree: dict, specs: dict) -> dict:
        return {k: shd.unshard(pieces, specs[k], mesh, dev)
                for k, pieces in tree.items()}

    return TrainState(
        params=join(state.params, p_spec),
        opt=adamw.AdamWState(step=state.opt.step[first].to(dev, copy=True),
                             mu=join(state.opt.mu, mu_spec),
                             nu=join(state.opt.nu, mu_spec)))


def clone_state(state: ShardedTrainState) -> ShardedTrainState:
    """A copy of every piece (a step that must not consume its input)."""
    def copy(tree: dict) -> dict:
        return {k: {c: t.clone() for c, t in pieces.items()}
                for k, pieces in tree.items()}

    return state._replace(
        params=copy(state.params),
        opt=adamw.AdamWState(
            step={c: t.clone() for c, t in state.opt.step.items()},
            mu=copy(state.opt.mu), nu=copy(state.opt.nu)))


def use_specs(p_spec: Mapping[str, tuple]) -> dict:
    """The layout a coordinate computes with: the rules' specs with the
    batch axes stripped (its model shard of every leaf, whole over
    ``data``)."""
    return {k: shd._strip_axes(s, BATCH_AXES) for k, s in p_spec.items()}


def _data_dim(spec: tuple) -> int | None:
    return next((j for j, e in enumerate(spec)
                 if set(shd.spec_axes(e)) & set(BATCH_AXES)), None)


def _chunk(t: torch.Tensor, dim: int, axes: tuple, mesh,
           c: tuple) -> torch.Tensor:
    """Coordinate ``c``'s chunk of ``t`` along ``dim`` split over ``axes``
    (major to minor), as ``sharding.shard_slices`` lays it out."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + c[mesh.axis(a)]
        n *= mesh.shape[a]
    w = t.shape[dim] // n
    return t.narrow(dim, idx * w, w)


def _whole(pieces: dict, dim: int, axes: tuple, mesh) -> dict:
    """Every coordinate's copy of the whole dim ``dim`` split over
    ``axes``: gathered over the minor axis first, so that each gather
    joins neighbouring chunks."""
    for a in reversed(axes):
        pieces = coll.all_gather(pieces, mesh, a, dim=dim, tiled=True)
    return pieces


def gather_leaf(pieces: dict, spec: tuple, mesh) -> dict:
    """One leaf's pieces -> each coordinate's piece in the ``use_specs``
    layout (gathered over ``data``; a dim over ``("data", "model")``
    gathered whole, then each coordinate's model block)."""
    j = _data_dim(spec)
    if j is None:
        return dict(pieces)
    axes = shd.spec_axes(spec[j])
    if axes == ("data",):
        return coll.all_gather(pieces, mesh, "data", dim=j, tiled=True)
    rest = tuple(a for a in axes if a not in BATCH_AXES)
    return {c: _chunk(t, j, rest, mesh, c).contiguous()
            for c, t in _whole(pieces, j, axes, mesh).items()}


def gather_params(params: dict, p_spec: Mapping[str, tuple], mesh) -> dict:
    """Every leaf gathered at use -> ``{coord: {key: piece}}``."""
    out: dict = {c: {} for c in mesh.coords()}
    for k, pieces in params.items():
        for c, t in gather_leaf(pieces, p_spec[k], mesh).items():
            out[c][k] = t
    return out


def reduce_grads(grads: Mapping[tuple, Mapping[str, torch.Tensor]],
                 p_spec: Mapping[str, tuple], mesh,
                 mu_spec: Mapping[str, tuple] | None = None) -> dict:
    """Each coordinate's autograd gradients in the ``use_specs`` layout ->
    ``{coord: {key: gradient of its piece}}``, of its moment's slice where
    ``mu_spec`` splits the moment over ``pod`` (module docstring)."""
    out: dict = {c: {} for c in mesh.coords()}
    for k, spec in p_spec.items():
        g = {c: grads[c][k] for c in mesh.coords()}
        if "model" in mesh.axis_names and not shd.splits(spec, "model"):
            g = coll.all_reduce(g, mesh, "model")
        j = _data_dim(spec)
        axes = shd.spec_axes(spec[j]) if j is not None else ()
        if axes == ("data",):
            g = coll.reduce_scatter(g, mesh, "data", dim=j)
        elif j is not None:  # the model blocks joined, each its chunk
            g = coll.all_reduce(g, mesh, "data")
            rest = tuple(a for a in axes if a not in BATCH_AXES)
            g = {c: _chunk(t, j, axes, mesh, c).contiguous()
                 for c, t in _whole(g, j, rest, mesh).items()}
        elif "data" in mesh.axis_names:
            g = coll.all_reduce(g, mesh, "data")
        if "pod" in mesh.axis_names:
            z = zero_dim(spec, mu_spec[k]) if mu_spec else None
            g = (coll.all_reduce(g, mesh, "pod") if z is None
                 else coll.reduce_scatter(g, mesh, "pod", dim=z))
        for c, t in g.items():
            out[c][k] = t
    return out


def _holds(coord: tuple, spec: tuple, mesh) -> bool:
    """Whether ``coord`` holds the copy of its piece that the global norm
    counts: index 0 on every axis the spec leaves whole."""
    split = {a for e in spec for a in shd.spec_axes(e)}
    return all(coord[i] == 0 for i, a in enumerate(mesh.axis_names)
               if a not in split)


def global_norm(grads: Mapping[tuple, Mapping[str, torch.Tensor]],
                p_spec: Mapping[str, tuple], mesh) -> dict:
    """The whole gradient's global norm on every coordinate: each distinct
    piece's float32 squared sum once, in the JAX tree's leaf order on each
    coordinate, then ``all_reduce``d over every axis."""
    sums = {}
    for c in mesh.coords():
        total = torch.zeros((), dtype=torch.float32, device=mesh.device(c))
        for k in leaf_order(grads[c]):
            if _holds(c, p_spec[k], mesh):
                total = total + torch.sum(
                    torch.square(grads[c][k].to(torch.float32)))
        sums[c] = total
    for axis in mesh.axis_names:
        sums = coll.all_reduce(sums, mesh, axis)
    return {c: torch.sqrt(s) for c, s in sums.items()}


def apply_adamw(opt_cfg: adamw.AdamWConfig, grads: dict,
                state: ShardedTrainState) -> tuple:
    """AdamW on every coordinate's pieces, in place -> (the new state,
    ``{"grad_norm", "lr"}`` of the first coordinate). ``grads`` are
    ``reduce_grads``' (a ZeRO'd leaf's of its moment's slice)."""
    mesh = state.mesh
    p_spec, mu_spec = state.specs
    zero = {k: z for k in p_spec
            if (z := zero_dim(p_spec[k], mu_spec[k])) is not None}
    g_spec = {k: mu_spec[k] if k in zero else p_spec[k] for k in p_spec}
    norms = global_norm(grads, g_spec, mesh)
    step, metrics, stepped = {}, None, {k: {} for k in zero}
    for c in mesh.coords():
        params = {k: pieces[c] for k, pieces in state.params.items()}
        for k, z in zero.items():  # the moment's sub-block of the piece
            params[k] = stepped[k][c] = _chunk(
                params[k], z, ("pod",), mesh, c).contiguous()
        opt = adamw.AdamWState(
            step=state.opt.step[c],
            mu={k: pieces[c] for k, pieces in state.opt.mu.items()},
            nu={k: pieces[c] for k, pieces in state.opt.nu.items()})
        _, new_opt, m = adamw.update(opt_cfg, grads[c], opt, params,
                                     gnorm=norms[c])
        step[c] = new_opt.step
        if metrics is None:
            metrics = m
    for k, z in zero.items():  # every replica gets every stepped sub-block
        for c, t in coll.all_gather(stepped[k], mesh, "pod", dim=z,
                                    tiled=True).items():
            state.params[k][c].copy_(t)
    return state._replace(opt=state.opt._replace(step=step)), metrics
