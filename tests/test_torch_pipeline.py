"""``repro_torch.distributed.pipeline`` and the mesh collectives against the
JAX package's ``repro.distributed.pipeline`` and ``collectives``.

``bubble_fraction`` and ``split_stages`` equal the reference's (its
``AssertionError`` is the port's ``ValueError``). ``pipeline_forward`` over
4 logical CPU stages matches the JAX ``reference_forward`` and the JAX
``pipeline_forward`` on 4 fake devices within 1e-5, and the port's own
``reference_forward``; ``compressed_psum`` over a 4-way axis matches the
JAX one under ``shard_map`` within 1e-6, and its gathered shards are int8.
The JAX side runs in one subprocess (``JAX_PLATFORMS=cpu``,
``--xla_force_host_platform_device_count=4``) with ``jax.make_mesh``
defaulting to ``Auto`` axes, a shim in this test's code (ROADMAP C16).
The port's ``all_reduce``, ``all_gather``, ``ppermute`` and ``pmax`` are
held to their definitions on a 2x2 mesh.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import pipeline as tpipe
from repro_torch.distributed.sharding import LogicalMesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, M, MB, D = 4, 6, 3, 8  # stages, microbatches, rows per microbatch, width


def inputs() -> tuple[dict, np.ndarray, list]:
    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal((S, D, D)).astype(np.float32) * 0.5,
              "b": rng.standard_normal((S, D)).astype(np.float32)}
    xs = rng.standard_normal((M, MB, D)).astype(np.float32)
    shards = [rng.standard_normal((5, 7)).astype(np.float32) * (i + 1)
              for i in range(4)]
    return params, xs, shards


_SUBPROCESS = """
import json
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P

_make_mesh = jax.make_mesh


def _auto_make_mesh(shape, axes, *a, **k):  # jax 0.9: Explicit by default
    k.setdefault("axis_types", (AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, *a, **k)


jax.make_mesh = _auto_make_mesh

from repro.configs import get_config
from repro.distributed import collectives, pipeline

params, xs, shards = inputs()
stage = lambda p, x: jnp.tanh(x @ p["w"] + p["b"])
mesh = jax.make_mesh((S,), ("stage",))
out = {
    "pipe": pipeline.pipeline_forward(stage, params, jnp.asarray(xs),
                                      mesh=mesh).tolist(),
    "ref": pipeline.reference_forward(stage, params, jnp.asarray(xs)).tolist(),
    "bubble": [pipeline.bubble_fraction(s, m) for s in (1, 2, 4, 8)
               for m in (1, 4, 16)],
}
split = {}
for name in ("olmo-1b", "qwen3-14b", "jamba-1.5-large-398b", "mamba2-370m"):
    for n in (1, 2, 3, 4, 8):
        try:
            split[f"{name}/{n}"] = pipeline.split_stages(get_config(name), n)
        except AssertionError:
            split[f"{name}/{n}"] = "raise"
out["split"] = split
pmesh = jax.make_mesh((4,), ("pod",))
fn = pipeline._shard_map(
    lambda x: collectives.compressed_psum(x[0], "pod")[None],
    mesh=pmesh, in_specs=P("pod"), out_specs=P("pod"))
out["cpsum"] = fn(jnp.stack([jnp.asarray(s) for s in shards])).tolist()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_runs():
    pytest.importorskip("jax")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=os.path.join(REPO, "src"),
    )
    code = "\n".join([
        "import numpy as np", f"S, M, MB, D = {S}, {M}, {MB}, {D}",
        inspect.getsource(inputs), textwrap.dedent(_SUBPROCESS)])
    out = subprocess.run(
        [sys.executable, "-c", code], env=env,
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def test_bubble_and_split_equal_jax(jax_runs):
    assert [tpipe.bubble_fraction(s, m) for s in (1, 2, 4, 8)
            for m in (1, 4, 16)] == jax_runs["bubble"]
    for key, want in jax_runs["split"].items():
        name, n = key.rsplit("/", 1)
        try:
            got = tpipe.split_stages(get_config(name), int(n))
        except ValueError:
            got = "raise"
        assert got == want, key


def test_pipeline_forward_matches_jax(jax_runs):
    params, xs, _ = inputs()
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    mesh = LogicalMesh((S,), ("stage",), ["cpu"] * S)
    got = tpipe.pipeline_forward(_stage, tparams, torch.from_numpy(xs),
                                 mesh=mesh)
    ref = tpipe.reference_forward(_stage, tparams, torch.from_numpy(xs))
    for want in (jax_runs["ref"], jax_runs["pipe"]):
        torch.testing.assert_close(
            got, torch.tensor(want, dtype=torch.float32), atol=1e-5, rtol=0)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


def test_compressed_psum_matches_jax(jax_runs):
    _, _, shards = inputs()
    mesh = LogicalMesh((4,), ("pod",), ["cpu"] * 4)
    xs = {(i,): torch.from_numpy(s) for i, s in enumerate(shards)}
    got = coll.compressed_psum(xs, mesh, "pod")
    want = torch.tensor(jax_runs["cpsum"], dtype=torch.float32)
    for i in range(4):
        torch.testing.assert_close(got[(i,)], want[i], atol=1e-6, rtol=0)
    # what crosses the axis is int8; the sum is within 4 quanta of exact
    scale = max(float(np.abs(s).max()) for s in shards) / 127.0
    wire = coll.all_gather(
        {c: coll._quantize(x, torch.tensor(scale)) for c, x in xs.items()},
        mesh, "pod")
    assert all(t.dtype == torch.int8 for t in wire.values())
    exact = torch.from_numpy(sum(shards))
    assert float((got[(0,)] - exact).abs().max()) <= 4 * scale


def test_collectives_on_a_2x2_mesh():
    """Sums and maxima over one axis in coordinate order, gathers in order,
    a ring ppermute (a coordinate off the permutation gets zeros)."""
    mesh = LogicalMesh((2, 2), ("data", "model"), ["cpu"] * 4)
    xs = {c: torch.full((3,), float(10 * c[0] + c[1])) for c in mesh.coords()}
    red = coll.all_reduce(xs, mesh, "model")
    assert [float(red[c][0]) for c in mesh.coords()] == [1.0, 1.0, 21.0, 21.0]
    mx = coll.pmax(xs, mesh, "data")
    assert [float(mx[c][0]) for c in mesh.coords()] == [10.0, 11.0, 10.0, 11.0]
    g = coll.all_gather(xs, mesh, "data")
    assert g[(0, 1)].shape == (2, 3) and g[(0, 1)][:, 0].tolist() == [1, 11]
    t = coll.all_gather(xs, mesh, "model", dim=0, tiled=True)
    assert t[(1, 0)].tolist() == [10.0] * 3 + [11.0] * 3
    ring = coll.ppermute(xs, mesh, "model", [(0, 1), (1, 0)])
    assert float(ring[(1, 0)][0]) == 11.0 and float(ring[(1, 1)][0]) == 10.0
    one = coll.ppermute(xs, mesh, "model", [(0, 1)])
    assert float(one[(1, 0)][0]) == 0.0 and float(one[(1, 1)][0]) == 10.0
