"""Training on a mesh of logical devices (ROADMAP A12 part 3 item 4)
against the JAX package on the same weights and batch.

The JAX package runs once, in one subprocess on 8 fake CPU devices
(``--xla_force_host_platform_device_count=8``), with the ``Auto``-axes shim
of ``tests/test_torch_mesh.py`` in this test's own code (ROADMAP C16): its
``lower_for`` train executable at (4, 2), (2, 2) and (1, 2), a checkpoint
of its (4, 2) state after one step, and the elastic re-mesh of
``tests/test_distributed.py`` (save at (4, 2), restore, place on (2, 2),
step). It writes its seeded weights, which the port then uses. The port
runs on ``devices=("cpu",) * n``, one torch thread. The olmo-1b smoke
config in fp32; a batch of 8 x 32 tokens from a numpy seed whose labels
hold pads spread unevenly over the data rows (a mean of the rows' means
would differ from the global mean).

* The loss at each mesh = the JAX package's at the same mesh, the port's
  1x1 mesh and its one device, within 2e-4 relative; after one step the
  unsharded params, moments and ``grad_norm`` = the port's one-device
  ``make_train_fn`` step within 1e-5; every replica of a piece equal bit
  for bit, and every piece its own storage.
* ``lower_train``'s ``opt_cfg`` reaches the step (1x2 = one device with
  the same optimizer).
* Elastic: place on (4, 2), step, save, restore (= the saved state bit for
  bit), place on (2, 2), step = an uninterrupted run and the JAX package's
  within 2e-4.
* Checkpoints: ``host_id=3, num_hosts=4`` writes ``host_0003.npz``; the
  JAX package's checkpoint of its sharded state loads in the port, and the
  port's of a sharded state in the JAX package.
* ``make_debug_mesh()`` refuses to fall back to the CPU.
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

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.optim import adamw
from repro_torch.runtime import steps
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((4, 2), (2, 2), (1, 2))
SHAPE = ShapeSpec("t", "train", 32, 8)
LOSS_RTOL = 2e-4  # the JAX package's own (tests/test_distributed.py)
STATE_ATOL = 1e-5  # fp32: the same sums in another order


def batch_arrays() -> dict:
    """8 x 32 tokens; pads from token 5 in row 0, from 20 in row 3, all of
    row 6 and the last token of row 7."""
    rng = np.random.default_rng(1)
    tok = rng.integers(0, 256, (8, 32)).astype(np.int32)
    lab = tok.copy()
    lab[0, 5:] = -1
    lab[3, 20:] = -1
    lab[6, :] = -1
    lab[7, 31] = -1
    return {"inputs": tok, "labels": lab}


_SUBPROCESS = """
import json
import sys

import jax
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

_make_mesh = jax.make_mesh


def _auto_make_mesh(shape, axes, *a, **k):  # jax 0.9: Explicit by default
    k.setdefault("axis_types", (AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, *a, **k)


jax.make_mesh = _auto_make_mesh

from repro import models
from repro.checkpoint.checkpoint import CheckpointManager
from repro.configs import ShapeSpec, get_config
from repro.optim import adamw
from repro.runtime import steps

OUT = sys.argv[1]
cfg = get_config("olmo-1b").smoke()
params = models.init_params(cfg, jax.random.PRNGKey(0))
np.savez(OUT + "/params.npz", **{
    ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
    np.asarray(v)
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]})
host_batch = batch_arrays()
shape = ShapeSpec("t", "train", 32, 8)


def fresh():
    return steps.TrainState(params=params, opt=adamw.init(params))


def on(mesh):
    return {k: jax.device_put(v, NamedSharding(mesh, P("data")))
            for k, v in host_batch.items()}


res = {}
for dp, mp in MESHES:
    mesh = jax.make_mesh((dp, mp), ("data", "model"),
                         devices=jax.devices()[:dp * mp])
    exe = steps.lower_for(cfg, mesh, shape, donate=False).compile()
    new, m = exe(steps.place_train_state(cfg, fresh(), mesh), on(mesh))
    res[f"{dp}x{mp}"] = {k: float(v) for k, v in m.items()}
    if (dp, mp) == (4, 2):
        big = new
CheckpointManager(OUT + "/jax_ck", async_write=False).save(1, big)
try:  # the elastic re-mesh of tests/test_distributed.py
    small = jax.make_mesh((2, 2), ("data", "model"),
                          devices=jax.devices()[:4])
    mgr = CheckpointManager(OUT + "/elastic", async_write=False)
    mgr.save(1, big)
    _, restored = mgr.restore(jax.eval_shape(fresh))
    exe = steps.lower_for(cfg, small, shape, donate=False).compile()
    _, m2 = exe(steps.place_train_state(cfg, restored, small), on(small))
    res["m2"] = float(m2["loss"])
except Exception as e:  # noqa: BLE001 - reported to the test
    res["m2_error"] = repr(e)[:500]
print("RESULT " + json.dumps(res))
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's steps on 8 fake devices (one subprocess): its
    results and the directory holding its weights and checkpoint."""
    pytest.importorskip("jax")
    out_dir = tmp_path_factory.mktemp("jax_train_mesh")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
        PYTHONPATH=os.path.join(REPO, "src"),
    )
    code = "\n".join([
        "import numpy as np", f"MESHES = {MESHES!r}",
        inspect.getsource(batch_arrays), textwrap.dedent(_SUBPROCESS)])
    out = subprocess.run(
        [sys.executable, "-c", code, str(out_dir)], env=env,
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), out_dir


@pytest.fixture(scope="module")
def cfg():
    return get_config("olmo-1b").smoke()


@pytest.fixture(scope="module")
def params(jax_run):
    """The JAX package's seeded weights, as the port's flat params."""
    with np.load(jax_run[1] / "params.npz") as z:
        return {k: torch.from_numpy(z[k].copy()) for k in z.files}


@pytest.fixture(scope="module")
def batch():
    return {k: torch.from_numpy(v) for k, v in batch_arrays().items()}


def _fresh(params: dict) -> steps.TrainState:
    p = {k: v.clone() for k, v in params.items()}
    return steps.TrainState(params=p, opt=adamw.init(p))


def _mesh(dp: int, mp: int):
    return tmesh.make_debug_mesh((dp, mp), devices=["cpu"] * (dp * mp))


@pytest.fixture(scope="module")
def one_device(cfg, params, batch):
    """Two steps of the port's one-device ``make_train_fn``: (metrics of
    each, the state after the first)."""
    fn = steps.make_train_fn(cfg)
    state, m1 = fn(_fresh(params), batch)
    after1 = steps.TrainState(
        params={k: v.clone() for k, v in state.params.items()},
        opt=adamw.AdamWState(step=state.opt.step.clone(),
                             mu={k: v.clone() for k, v in state.opt.mu.items()},
                             nu={k: v.clone() for k, v in state.opt.nu.items()}))
    _, m2 = fn(state, batch)
    return m1, m2, after1


def _step(cfg, params, batch, dp, mp, **kw):
    mesh = _mesh(dp, mp)
    state = steps.place_train_state(cfg, _fresh(params), mesh)
    exe = steps.lower_for(cfg, mesh, SHAPE, **kw).compile()
    return mesh, state, exe(state, batch)


@pytest.fixture(scope="module")
def loss_1x1(cfg, params, batch):
    """The port's sharded step on a mesh of one device."""
    return float(_step(cfg, params, batch, 1, 1)[2][1]["loss"])


@pytest.mark.parametrize("dp,mp", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_train_step_on_mesh_equals_jax_and_one_device(
        jax_run, cfg, params, batch, one_device, loss_1x1, dp, mp):
    ref, _ = jax_run
    m1, _, after1 = one_device
    _, before, (state, m) = _step(cfg, params, batch, dp, mp)
    loss = float(m["loss"])
    np.testing.assert_allclose(loss, ref[f"{dp}x{mp}"]["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, loss_1x1, rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, float(m1["loss"]), rtol=LOSS_RTOL)
    assert float(m["ntok"]) == ref[f"{dp}x{mp}"]["ntok"] == 184.0
    np.testing.assert_allclose(float(m["grad_norm"]), float(m1["grad_norm"]),
                               rtol=0, atol=STATE_ATOL)
    assert state is not before and state.params is before.params  # donated
    got = fsdp.unshard_state(state)
    assert int(got.opt.step) == int(after1.opt.step) == 1
    for tree, want in ((got.params, after1.params), (got.opt.mu, after1.opt.mu),
                       (got.opt.nu, after1.opt.nu)):
        for k, w in want.items():
            torch.testing.assert_close(tree[k], w, rtol=0, atol=STATE_ATOL,
                                       msg=lambda s, k=k: f"{k}: {s}")


def _replica_groups(state: fsdp.ShardedTrainState):
    """Every leaf's pieces grouped by the global slice they hold."""
    mesh = state.mesh
    p_spec, mu_spec = state.specs
    for tree, specs in ((state.params, p_spec), (state.opt.mu, mu_spec),
                        (state.opt.nu, mu_spec)):
        for k, pieces in tree.items():
            shape = tuple(s * n for s, n in zip(
                pieces[mesh.coords()[0]].shape,
                [shd._axes_size(shd.spec_axes(e), mesh)
                 for e in specs[k]]))
            groups: dict = {}
            for c, t in pieces.items():
                sl = shd.shard_slices(shape, specs[k], mesh, c)
                groups.setdefault(tuple((s.start, s.stop) for s in sl),
                                  []).append(t)
            yield k, groups


@pytest.mark.parametrize("dp,mp", [(2, 4), (1, 4)], ids=["2x4", "1x4"])
def test_replicas_stay_equal_and_own_their_storage(cfg, params, batch, dp, mp):
    """Two steps (AdamW in place on each coordinate's pieces): replicas of
    a piece equal bit for bit, no two pieces share storage. With a model
    axis of 4 the two kv heads are whole on every model shard (``wk`` and
    ``wv`` replicated over ``model``, split over ``data`` at 2x4)."""
    mesh = _mesh(dp, mp)
    state = steps.place_train_state(cfg, _fresh(params), mesh)
    exe = steps.lower_for(cfg, mesh, SHAPE).compile()
    for _ in range(2):
        state, _ = exe(state, batch)
    ptrs = [t.data_ptr() for tree in (state.params, state.opt.mu,
                                      state.opt.nu)
            for pieces in tree.values() for t in pieces.values()]
    assert len(set(ptrs)) == len(ptrs)
    replicated = 0
    for k, groups in _replica_groups(state):
        for ts in groups.values():
            replicated += len(ts) > 1
            for t in ts[1:]:
                assert torch.equal(t, ts[0]), k
    assert replicated > 0
    steps_ = {int(t) for t in state.opt.step.values()}
    assert steps_ == {2}


def test_lower_train_steps_with_the_optimizer_given(cfg, params, batch,
                                                   one_device):
    """``opt_cfg`` reaches the step: at 1x2 with a peak_lr of 1e-3 and 2
    warmup steps the first step's lr is 5e-4, and the state after it = the
    one-device step's with the same optimizer (and the default's moments:
    the optimizer changes only how far the params move)."""
    opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=12)
    mesh = _mesh(1, 2)
    state = steps.place_train_state(cfg, _fresh(params), mesh)
    state, m = steps.lower_train(cfg, mesh, SHAPE, opt_cfg=opt).compile()(
        state, batch)
    one, m1 = steps.make_train_fn(cfg, opt)(_fresh(params), batch)
    assert float(m["lr"]) == float(m1["lr"]) == pytest.approx(5e-4)
    got = fsdp.unshard_state(state)
    _, _, default = one_device
    for tree, want in ((got.params, one.params), (got.opt.mu, one.opt.mu),
                       (got.opt.nu, one.opt.nu),
                       (got.opt.mu, default.opt.mu)):
        for k, w in want.items():
            torch.testing.assert_close(tree[k], w, rtol=0, atol=STATE_ATOL,
                                       msg=lambda s, k=k: f"{k}: {s}")
    moved = max(float((got.params[k] - default.params[k]).abs().max())
                for k in params)
    assert moved > 1e-4  # 5e-4 against the default's 3e-6


def test_donate_false_leaves_the_state(cfg, params, batch):
    mesh, state, (new, _) = _step(cfg, params, batch, 2, 2, donate=False)
    want = _fresh(params).params
    got = fsdp.unshard_state(state).params
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert new.params is not state.params


def test_elastic_restore_continues_as_uninterrupted(
        jax_run, cfg, params, batch, one_device, tmp_path):
    """Place on (4, 2), step, save, restore, place on (2, 2), step: the
    second step's loss = the uninterrupted run's and the JAX package's."""
    ref, _ = jax_run
    assert "m2_error" not in ref, ref.get("m2_error")
    _, _, (state, _) = _step(cfg, params, batch, 4, 2)
    mgr = CheckpointManager(tmp_path / "ck", async_write=False)
    mgr.save(1, state)
    _, restored = mgr.restore(_fresh(params))
    saved = fsdp.unshard_state(state)
    assert torch.equal(restored.opt.step, saved.opt.step)
    for tree, want in ((restored.params, saved.params),
                       (restored.opt.mu, saved.opt.mu),
                       (restored.opt.nu, saved.opt.nu)):
        assert all(torch.equal(tree[k], v) for k, v in want.items())
    small = _mesh(2, 2)
    placed = steps.place_train_state(cfg, restored, small)
    assert placed.mesh is small
    exe = steps.lower_for(cfg, small, SHAPE).compile()
    _, m2 = exe(placed, batch)
    _, m_ref, _ = one_device
    np.testing.assert_allclose(float(m2["loss"]), float(m_ref["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m2["loss"]), ref["m2"], rtol=LOSS_RTOL)
    # a state sharded on one mesh placed straight onto another
    again = steps.place_train_state(cfg, placed, _mesh(1, 2))
    for k, v in fsdp.unshard_state(placed).params.items():
        assert torch.equal(fsdp.unshard_state(again).params[k], v)


def test_checkpoint_names_the_host_file(cfg, params, tmp_path):
    mgr = CheckpointManager(tmp_path, host_id=3, num_hosts=4,
                            async_write=False)
    assert (mgr.host_id, mgr.num_hosts) == (3, 4)
    state = steps.place_train_state(cfg, _fresh(params), _mesh(2, 2))
    mgr.save(5, state)
    assert sorted(p.name for p in (tmp_path / "step_00000005").iterdir()) == [
        "META.json", "host_0003.npz"]
    step, back = mgr.restore(_fresh(params))
    assert step == 5
    for k, v in params.items():
        assert torch.equal(back.params[k], v)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path, host_id=0, async_write=False).restore(
            _fresh(params))


def test_jax_checkpoint_of_a_sharded_state_loads_in_the_port(
        jax_run, cfg, params, batch):
    """The JAX package's (4, 2) state after one step, restored and placed on
    a port mesh: its arrays bit for bit, within 1e-5 of the port's own
    (4, 2) step."""
    _, out_dir = jax_run
    mgr = CheckpointManager(out_dir / "jax_ck", async_write=False)
    step, restored = mgr.restore(_fresh(params))
    assert step == 1
    placed = steps.place_train_state(cfg, restored, _mesh(4, 2))
    joined = fsdp.unshard_state(placed)
    with np.load(out_dir / "jax_ck" / "step_00000001" / "host_0000.npz") as z:
        for k in params:
            key = ".params/" + k.replace(".", "/")
            np.testing.assert_array_equal(joined.params[k].numpy(), z[key])
    _, _, (own, _) = _step(cfg, params, batch, 4, 2)
    mine = fsdp.unshard_state(own)
    for k in params:
        torch.testing.assert_close(joined.params[k], mine.params[k], rtol=0,
                                   atol=STATE_ATOL)
        torch.testing.assert_close(joined.opt.nu[k], mine.opt.nu[k], rtol=0,
                                   atol=STATE_ATOL)


def test_port_checkpoint_of_a_sharded_state_loads_in_jax(
        cfg, params, batch, tmp_path):
    jax = pytest.importorskip("jax")
    from repro import models as jm
    from repro.checkpoint.checkpoint import CheckpointManager as JaxManager
    from repro.configs import get_config as jax_config
    from repro.optim import adamw as jadamw
    from repro.runtime import steps as jsteps

    _, _, (state, _) = _step(cfg, params, batch, 2, 2)
    CheckpointManager(tmp_path, async_write=False).save(1, state)
    jcfg = jax_config("olmo-1b").smoke()
    template = jax.eval_shape(lambda: jsteps.TrainState(
        params=jm.init_params(jcfg, jax.random.PRNGKey(0)),
        opt=jadamw.init(jm.init_params(jcfg, jax.random.PRNGKey(0)))))
    step, back = JaxManager(tmp_path, async_write=False).restore(template)
    assert step == 1
    joined = fsdp.unshard_state(state)
    leaves = jax.tree_util.tree_flatten_with_path(back.params)[0]
    assert len(leaves) == len(params)
    for path, leaf in leaves:
        k = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)
        np.testing.assert_array_equal(np.asarray(leaf),
                                      joined.params[k].numpy())
    assert int(back.opt.step) == 1


def test_make_debug_mesh_has_no_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_debug_mesh()
    mesh = tmesh.make_debug_mesh((2, 2), devices=["cpu"] * 4)
    assert mesh.size == 4 and {str(d) for d in mesh.devices} == {"cpu"}
    assert {str(d) for d in tmesh.make_production_mesh().devices} == {"meta"}


def test_reduce_scatter_sums_and_keeps_each_slice():
    from repro_torch.distributed import collectives as coll

    mesh = _mesh(2, 2)
    rng = np.random.default_rng(0)
    xs = {c: torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
          for c in mesh.coords()}
    got = coll.reduce_scatter(xs, mesh, "data", dim=1)
    for c in mesh.coords():
        whole = xs[(0, c[1])] + xs[(1, c[1])]
        assert torch.equal(got[c], whole[:, 3 * c[0]:3 * (c[0] + 1)])
    with pytest.raises(ValueError, match="does not divide"):
        coll.reduce_scatter({c: x[:, :5] for c, x in xs.items()}, mesh,
                            "data", dim=1)


def test_non_dense_families_and_kernel_impl_are_refused(cfg):
    mesh = _mesh(2, 2)
    with pytest.raises(NotImplementedError, match="A12 part 3"):
        steps.lower_for(get_config("mamba2-370m").smoke(), mesh, SHAPE)
    with pytest.raises(ValueError, match="naive"):
        steps.lower_for(cfg, mesh, SHAPE, impl="kernel")
    with pytest.raises(ValueError, match="divide"):
        state = steps.place_train_state(cfg, steps.state_shapes(cfg),
                                        tmesh.make_debug_mesh(
                                            (4, 2), devices=["meta"] * 8))
        exe = steps.lower_for(cfg, state.mesh, SHAPE).compile()
        exe(state, {k: torch.zeros(6, 32, dtype=torch.int32,
                                   device="meta")
                    for k in ("inputs", "labels")})
