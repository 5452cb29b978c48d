"""The spec rules of ``repro_torch.distributed.sharding`` against the JAX
package's ``repro.distributed.sharding``, leaf for leaf, as tuples.

All 11 configs (the JAX package's ``ASSIGNED`` and hft-demo) at the
production meshes ``AbstractMesh((16, 16), ("data", "model"))`` and
``AbstractMesh((2, 16, 16), ("pod", "data", "model"))`` and the serving
meshes (1, 2) and (2, 2): ``param_pspec_tree``, ``opt_pspec_tree`` (ZeRO
over ``pod`` where the config asks), ``cache_pspec_tree`` (the dense cache
at 128 x 32768 and at 1 x 524288) and ``data_pspec``; and ``MeshPlan``'s
four builders (``param_specs``, ``row_spec``, ``dense_cache_specs``,
``paged_cache_specs``) at "1x2" and "2x2" against the JAX plan's shardings
over an ``AbstractMesh`` of the same shape. The JAX shapes come from
``jax.eval_shape``, the port's from its own ``init_*`` on the ``meta``
device, so nothing is allocated; the flat keys must agree too. The JAX
package leaves an unmatched leaf's spec empty (``P()``); the port gives one
``None`` per dim, so the JAX spec is padded with ``None`` before the
comparison.
"""

from __future__ import annotations

import pytest

from repro_torch import models as tm
from repro_torch.configs import get_config as tget
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import mesh as tmesh

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ASSIGNED, get_config as jget  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402

CONFIGS = tuple(ASSIGNED) + ("hft-demo",)
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x2": ((1, 2), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}
CACHES = ((128, 32768), (1, 524288))


def _key(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _flat(tree) -> dict:
    """A JAX tree of specs (or shapes) as {flat key: leaf}."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {_key(path): leaf for path, leaf in leaves}


def _flat_list(tree: list) -> dict:
    """The port's per-period-slot list of dicts as {"i.name": leaf}."""
    return {f"{i}.{n}": v for i, d in enumerate(tree) for n, v in d.items()}


def _same(jspecs: dict, tspecs: dict, shapes: dict) -> None:
    assert set(jspecs) == set(tspecs)
    for k, t in tspecs.items():
        j = tuple(jspecs[k])
        j = j + (None,) * (len(shapes[k].shape) - len(j))
        assert j == t, (k, j, t)


@pytest.fixture(scope="module")
def shapes():
    """Per config: the JAX params' shapes and the port's meta params."""
    out = {}
    for name in CONFIGS:
        jcfg = jget(name)
        out[name] = (
            jcfg,
            jax.eval_shape(lambda c=jcfg: jm.init_params(
                c, jax.random.PRNGKey(0))),
            tm.init_params(tget(name), device="meta"),
        )
    return out


def _mesh(name: str):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), tshd.LogicalMesh(
        sizes, axes, ["meta"] * (sizes[0] * sizes[1] * (
            sizes[2] if len(sizes) > 2 else 1)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", CONFIGS)
def test_param_and_opt_specs_equal_jax(shapes, arch, mesh):
    jcfg, jshapes, tparams = shapes[arch]
    jmesh, tmsh = _mesh(mesh)
    flat_shapes = _flat(jshapes)
    assert set(flat_shapes) == set(tparams)
    for k, t in tparams.items():
        assert tuple(t.shape) == tuple(flat_shapes[k].shape), k
    jp = jshd.param_pspec_tree(jshapes, jmesh)
    tp = tshd.param_pspec_tree(tparams, tmsh)
    _same(_flat(jp), tp, tparams)
    jo = jshd.opt_pspec_tree(jcfg, jp, jshapes, jmesh)
    to = tshd.opt_pspec_tree(tget(arch), tp, tparams, tmsh)
    _same(_flat(jo), to, tparams)
    if mesh == "2x16x16" and jcfg.zero_over_pod:  # the upgrade happened
        assert to != tp


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", CONFIGS)
def test_cache_and_data_specs_equal_jax(arch, mesh):
    jmesh, tmsh = _mesh(mesh)
    for batch, seq in CACHES:
        jc = jax.eval_shape(lambda: jm.init_cache(jget(arch), batch, seq))
        tc = tm.init_cache(tget(arch), batch, seq, device="meta")
        flat_t = _flat_list(tc)
        _same(_flat(jshd.cache_pspec_tree(jget(arch), jc, jmesh)),
              _flat_list(tshd.cache_pspec_tree(tget(arch), tc, tmsh)),
              flat_t)
    for shape in ((256, 128), (16, 128), (1, 128), (4, 8, 2)):
        assert tuple(jshd.data_pspec(shape, jmesh)) == tshd.data_pspec(
            shape, tmsh)


@pytest.mark.parametrize("name", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", CONFIGS)
def test_mesh_plan_builders_equal_jax(shapes, arch, name):
    """The serving plan's four spec builders, against the JAX plan's
    shardings over an abstract mesh of the plan's shape."""
    jcfg, jshapes, tparams = shapes[arch]
    jplan = jshd.MeshPlan(name)
    jplan._mesh = AbstractMesh((jplan.dp, jplan.mp), jshd.SERVING_AXES)
    tplan = tshd.MeshPlan(name)

    def specs(tree):
        return _flat(jax.tree.map(lambda s: s.spec, tree,
                                  is_leaf=lambda x: hasattr(x, "spec")))

    _same(specs(jplan.param_shardings(jshapes)),
          tplan.param_specs(tparams), tparams)
    for shape in ((8, 1), (8,), (3, 4), (8, 16), (1, 2)):
        assert tuple(jplan.row_sharding(shape).spec) + (None,) * (
            len(shape) - len(jplan.row_sharding(shape).spec)
        ) == tplan.row_spec(shape)
    jc = jax.eval_shape(lambda: jm.init_cache(jcfg, 8, 64))
    tc = tm.init_cache(tget(arch), 8, 64, device="meta")
    _same(specs(jplan.dense_cache_shardings(jc)),
          _flat_list(tplan.dense_cache_specs(tc)), _flat_list(tc))
    if not all(jcfg.mixer_at(s).startswith("attn")
               for s in range(jcfg.period)):
        return  # a mamba slot has no pages
    for kv_dtype in ("fp32", "int8"):
        jpc = jax.eval_shape(lambda: jm.init_paged_cache(jcfg, 34, 16,
                                                         kv_dtype))
        tpc = tm.init_paged_cache(tget(arch), 34, 16, kv_dtype,
                                  device="meta")
        _same(specs(jplan.paged_cache_shardings(jpc)),
              _flat_list(tplan.paged_cache_specs(tpc)), _flat_list(tpc))


def test_production_and_debug_meshes():
    """``launch.mesh`` as the JAX package's: the production meshes' shapes
    and axes, over ``meta`` devices (nothing allocated), and a debug mesh
    of logical CPU devices."""
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.shape) == (
        ("data", "model"), {"data": 16, "model": 16})
    assert (multi.axis_names, multi.shape) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16})
    assert {d.type for d in multi.devices} == {"meta"} and multi.size == 512
    dbg = tmesh.make_debug_mesh((2, 2), devices=["cpu"] * 4)
    assert dbg.shape == {"data": 2, "model": 2}
    assert dbg.coords() == [(0, 0), (0, 1), (1, 0), (1, 1)]
    with pytest.raises(ValueError, match="needs 4 devices"):
        tshd.LogicalMesh((2, 2), ("data", "model"), ["cpu"] * 3)
