"""The port's training slice against the JAX package's (CPU, fp32 unless
named): ``optim.adamw`` (``schedule``; ``update`` over random trees, fp32
and bf16 params, clipping on and off: params and moments within 1e-6
relative, bf16 params within one bf16 rounding; in place, slab by slab),
``data.pipeline`` (``batch_at`` bit for bit: tokens, embeddings,
``pad_frac``, host shards; the prefetcher's order),
``distributed.collectives`` (the quantised trees and the grad compressor,
8 and 16 bits, with and without error feedback, over two rounds), three
``make_train_fn`` steps of olmo-1b's smoke config from the same weights
(the port's seeded ones, in both packages) through a bf16 grad compressor
(loss within 1e-5 relative),
``checkpoint.checkpoint`` (round trip, GC, the missing-checkpoint error,
JAX -> port and port -> JAX loads, a bf16 state restored bit for bit and
written as the JAX package's ``|V2`` bytes, the restart contract of
``tests/test_substrate.py``) and the launcher as a subprocess
(``--resume``)."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import models
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.distributed import collectives as tcoll
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.steps import TrainState, make_train_fn, state_shapes
from test_torch_loss import port_weights_as_jax
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-6  # fp32 elementwise arithmetic, the same ops in another library


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import models as jm
    from repro.checkpoint import checkpoint as jckpt
    from repro.data import pipeline as jpipe
    from repro.distributed import collectives as jcoll
    from repro.optim import adamw as jadamw
    from repro.runtime import steps as jsteps

    return dict(jax=jax, jnp=jnp, models=jm, ckpt=jckpt, pipe=jpipe,
                coll=jcoll, adamw=jadamw, steps=jsteps)


def _np(tree, jax):
    return jax.tree.map(np.asarray, tree)


def _tree(seed: int) -> dict:
    """A params-like tree of numpy leaves: lists and nested dicts, keys
    whose sorted order differs from their insertion order."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"head": {"w": leaf(5, 3)}, "embed": {"embedding": leaf(7, 4)},
            "blocks": [{"mlp": {"w_up": leaf(2, 4, 6), "w_down": leaf(2, 6, 4)},
                        "attn": {"wq": leaf(2, 4, 2, 3)}},
                       {"norm1": {"scale": leaf(2, 4)}}]}


def _cast(tree, jx, dtype):
    return jx["jax"].tree.map(lambda a: jx["jnp"].asarray(a, dtype), tree)


def _assert_tree(got: dict, want, jax, rtol=RTOL, atol=0.0, what=""):
    flat = params_from_jax(_np(want, jax))
    assert set(got) == set(flat), what
    for k, w in flat.items():
        g = got[k]
        assert g.dtype == w.dtype, (what, k)
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol,
                                   msg=lambda m: f"{what} {k}: {m}")


# ------------------------------------------------------------------ adamw
def test_schedule_equals_jax(jx):
    cfg = dict(peak_lr=1e-3, warmup_steps=10, total_steps=100,
               min_lr_frac=0.1)
    tcfg, jcfg = tadamw.AdamWConfig(**cfg), jx["adamw"].AdamWConfig(**cfg)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = tadamw.schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        want = np.asarray(jx["adamw"].schedule(jcfg, jx["jnp"].int32(step)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("clip_norm", [1e9, 0.5], ids=["no clip", "clip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_equals_jax(jx, dtype, clip_norm):
    """Three updates of a random tree: params, mu, nu, step, grad_norm and
    lr. bf16 params: the f32 update rounds back to bf16 in both, so they
    agree within one rounding (2^-8 relative)."""
    jax, jnp = jx["jax"], jx["jnp"]
    jdt = getattr(jnp, dtype)
    cfg = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
               clip_norm=clip_norm)
    tcfg, jcfg = tadamw.AdamWConfig(**cfg), jx["adamw"].AdamWConfig(**cfg)
    jp = _cast(_tree(0), jx, jdt)
    tp = params_from_jax(_np(jp, jax))
    jst, tst = jx["adamw"].init(jp), tadamw.init(tp)
    tol = dict(rtol=2 ** -8, atol=0) if dtype == "bfloat16" else {}
    for i in range(3):
        jg = _cast(_tree(10 + i), jx, jdt)
        tg = params_from_jax(_np(jg, jax))
        jp, jst, jm = jx["adamw"].update(jcfg, jg, jst, jp)
        tp, tst, tm = tadamw.update(tcfg, tg, tst, tp)
        _assert_tree(tp, jp, jax, what=f"params {i}", **tol)
        # atol: m = b1 m + (1 - b1) g cancels on a few elements
        _assert_tree(tst.mu, jst.mu, jax, atol=1e-8, what=f"mu {i}")
        _assert_tree(tst.nu, jst.nu, jax, atol=1e-8, what=f"nu {i}")
        assert tst.step.dtype == torch.int32 and int(tst.step) == i + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=RTOL)
    if clip_norm < 1:
        assert float(tm["grad_norm"]) > clip_norm  # the clip was taken


def test_update_in_place_slab_by_slab(monkeypatch):
    """The update overwrites the params and moments it is given and returns
    them; slabs of 7 elements (leaves of 8-48 cut mid-row) give the
    whole-leaf result bit for bit."""
    cfg = tadamw.AdamWConfig(peak_lr=1e-2, warmup_steps=0, clip_norm=0.5)
    g = params_from_jax(_tree(1))
    runs = []
    for slab in (1 << 26, 7):
        monkeypatch.setattr(tadamw, "_SLAB", slab)
        p = params_from_jax(_tree(0))
        st = tadamw.init(p)
        new_p, new_s, _ = tadamw.update(cfg, g, st, p)
        assert all(new_p[k] is p[k] and new_s.mu[k] is st.mu[k]
                   and new_s.nu[k] is st.nu[k] for k in p)
        runs.append((new_p, new_s))
    (p1, s1), (p2, s2) = runs
    for k in p1:
        assert torch.equal(p1[k], p2[k]) and torch.equal(s1.nu[k], s2.nu[k])
        assert torch.equal(s1.mu[k], s2.mu[k])


def test_first_step_matches_hand_math():
    """The twin of ``test_substrate``'s: bias-corrected first step, mhat =
    g and vhat = g^2, so delta = sign(g)."""
    cfg = tadamw.AdamWConfig(peak_lr=0.1, warmup_steps=0, total_steps=10,
                             weight_decay=0.0, clip_norm=1e9, b1=0.9,
                             b2=0.999, eps=0.0, min_lr_frac=1.0)
    p, _, _ = tadamw.update(cfg, {"w": torch.tensor([0.5, -0.5])},
                            tadamw.init({"w": torch.tensor([1.0, 2.0])}),
                            {"w": torch.tensor([1.0, 2.0])})
    torch.testing.assert_close(p["w"], torch.tensor([0.9, 2.1]))


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("arch, pad_frac, host", [
    ("olmo-1b", 0.0, (0, 1)), ("olmo-1b", 0.25, (1, 2)),
    ("internvl2-1b", 0.0, (0, 1)), ("internvl2-1b", 0.5, (1, 2)),
])
def test_batch_at_is_bit_equal(jx, arch, pad_frac, host):
    from repro.configs import get_config as jax_config

    dc = dict(global_batch=4, seq_len=12, seed=3, pad_frac=pad_frac)
    jd = jx["pipe"].SyntheticLM(jax_config(arch).smoke(),
                                jx["pipe"].DataConfig(**dc))
    td = SyntheticLM(get_config(arch).smoke(), DataConfig(**dc))
    for step in (0, 7):
        want, got = jd.batch_at(step, *host), td.batch_at(step, *host)
        for k in ("inputs", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    if pad_frac:
        assert (got["labels"][:, -int(12 * pad_frac):] == -1).all()


def test_prefetcher_yields_in_order():
    src = SyntheticLM(get_config("olmo-1b").smoke(), DataConfig(2, 8))
    pf = Prefetcher(src, start_step=10, depth=2)
    try:
        it = iter(pf)
        for want in (10, 11, 12):
            step, batch = next(it)
            assert step == want
            np.testing.assert_array_equal(batch["inputs"],
                                          src.batch_at(step)["inputs"])
    finally:
        pf.close()


# ------------------------------------------------------------ collectives
def test_quantize_tree_equals_jax(jx):
    jax = jx["jax"]
    tree = _tree(5)
    jq, js = jx["coll"].quantize_tree(tree)
    tq, ts = tcoll.quantize_tree(params_from_jax(tree))
    _assert_tree(tq, jq, jax, rtol=0)
    _assert_tree(ts, js, jax, rtol=0)
    _assert_tree(tcoll.dequantize_tree(tq, ts),
                 jx["coll"].dequantize_tree(jq, js), jax, rtol=0)


@pytest.mark.parametrize("bits, ef", [(8, True), (8, False), (16, True),
                                      (16, False)])
def test_grad_compressor_equals_jax(jx, bits, ef):
    jax = jx["jax"]
    jc, jinit = jx["coll"].make_grad_compressor(bits, ef)
    tc, tinit = tcoll.make_grad_compressor(bits, ef)
    g0 = _tree(6)
    jr, tr = jinit(g0), tinit(params_from_jax(g0))
    for i in range(2):
        g = _tree(7 + i)
        jg, jr = jc(g, jr)
        tg, tr = tc(params_from_jax(g), tr)
        _assert_tree(tg, jg, jax, rtol=0, what=f"grads {i}")
        _assert_tree(tr, jr, jax, rtol=0, atol=1e-7, what=f"residual {i}")
    assert any(float(r.abs().max()) > 0 for r in tr.values()) == ef


# --------------------------------------------------------------- training
SMOKE = get_config("olmo-1b").smoke()
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


def _state(params: dict) -> TrainState:
    return TrainState(params=params, opt=tadamw.init(params))


def _batch(data, step: int) -> dict:
    return {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}


@pytest.fixture(scope="module")
def jweights(jx):
    from repro.configs import get_config as jax_config

    cfg = jax_config("olmo-1b").smoke()
    return cfg, port_weights_as_jax(jx["jax"], jx["models"], cfg,
                                    models.init_params(SMOKE, seed=0))


def test_three_train_steps_equal_jax_with_the_compressor(jx, jweights):
    """A compressor between the gradient and AdamW (bf16, no error
    feedback), three steps on the same batches from the same weights. Not
    int8: where the two libraries' gradients straddle a rounding boundary
    an int8 level flips, a whole level on a small element, which AdamW's
    normalised step turns into O(lr) on that parameter
    (``test_grad_compressor_equals_jax`` holds int8 on equal inputs)."""
    jax = jx["jax"]
    jcfg, jp = jweights
    data = SyntheticLM(SMOKE, DataConfig(2, 8, seed=1))
    jc, jinit = jx["coll"].make_grad_compressor(16, False)
    tc, tinit = tcoll.make_grad_compressor(16, False)
    jfn = jax.jit(jx["steps"].make_train_fn(
        jcfg, jx["adamw"].AdamWConfig(**OPT),
        grad_compress=lambda g: jc(g, jinit(g))[0]))
    tfn = make_train_fn(SMOKE, tadamw.AdamWConfig(**OPT),
                        grad_compress=lambda g: tc(g, tinit(g))[0])
    js = jx["steps"].TrainState(params=jp, opt=jx["adamw"].init(jp))
    ts = _state(params_from_jax(_np(jp, jax)))
    for i in range(3):
        js, jm = jfn(js, data.batch_at(i))
        ts, tm = tfn(ts, _batch(data, i))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        for k in ("ce", "moe_aux", "ntok", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    _assert_tree(ts.params, js.params, jax, rtol=1e-4, atol=1e-5)
    # a gradient element on a bf16 rounding boundary in one library and not
    # the other moves mu by (1 - b1) of a bf16 ulp of that element
    _assert_tree(ts.opt.mu, js.opt.mu, jax, rtol=1e-3, atol=1e-5)


# ------------------------------------------------------------- checkpoint
def _trained(steps: int, seed: int = 0) -> TrainState:
    data = SyntheticLM(SMOKE, DataConfig(2, 8))
    fn = make_train_fn(SMOKE, tadamw.AdamWConfig(peak_lr=1e-3))
    st = _state(models.init_params(SMOKE, seed=seed))
    for i in range(steps):
        st, _ = fn(st, _batch(data, i))
    return st


def _assert_state_equal(a: TrainState, b: TrainState) -> None:
    for x, y in ((a.params, b.params), (a.opt.mu, b.opt.mu),
                 (a.opt.nu, b.opt.nu)):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]), k
    assert a.opt.step.dtype == b.opt.step.dtype == torch.int32
    assert int(a.opt.step) == int(b.opt.step)


def test_checkpoint_roundtrip_gc_and_missing(tmp_path):
    st = _trained(1)
    mgr = CheckpointManager(tmp_path, keep=2, async_write=True)
    with pytest.raises(FileNotFoundError):
        mgr.restore(st)
    for s in (1, 2, 3, 4):
        mgr.save(s, st, meta={"arch": SMOKE.name})
    mgr.wait()
    assert mgr.list_steps() == [3, 4] and mgr.latest_step() == 4
    step, back = mgr.restore(
        _state({k: torch.empty_like(v) for k, v in st.params.items()}))
    assert step == 4
    _assert_state_equal(back, st)
    assert '"arch": "olmo-1b-smoke"' in (tmp_path / "step_00000004" /
                                         "META.json").read_text()


def test_state_shapes_allocate_nothing():
    st = state_shapes(SMOKE)
    assert {t.device.type for t in st.params.values()} == {"meta"}
    assert set(st.opt.mu) == set(st.params)
    assert all(t.dtype == torch.float32 for t in st.opt.nu.values())


def test_checkpoints_load_across_packages(jx, jweights, tmp_path):
    """JAX writes -> the port restores, and the port writes -> JAX
    restores, fp32: every leaf bit for bit, under the JAX key names."""
    jax = jx["jax"]
    jcfg, jp = jweights
    js = jx["steps"].TrainState(params=jp, opt=jx["adamw"].init(jp))
    js = js._replace(opt=js.opt._replace(step=jx["jnp"].int32(5)))
    jx["ckpt"].CheckpointManager(tmp_path / "j", async_write=False).save(5, js)
    ts = _state(models.init_params(SMOKE, seed=3))
    step, got = CheckpointManager(tmp_path / "j").restore(ts)
    assert step == 5 and int(got.opt.step) == 5
    _assert_tree(got.params, jp, jax, rtol=0)
    # the port's state, written by the port, read by JAX
    ts = _trained(2)
    CheckpointManager(tmp_path / "t", async_write=False).save(2, ts)
    step, back = jx["ckpt"].CheckpointManager(tmp_path / "t").restore(
        jax.eval_shape(lambda: js))
    assert step == 2 and int(back.opt.step) == 2
    _assert_tree(ts.params, back.params, jax, rtol=0)
    _assert_tree(ts.opt.nu, back.opt.nu, jax, rtol=0)
    with np.load(tmp_path / "t" / "step_00000002" / "host_0000.npz") as z:
        assert ".params/blocks/0/attn/wk" in z.files
        assert {".opt/.step", ".opt/.mu/blocks/0/attn/wq"} <= set(z.files)


def test_bf16_state_restores_and_writes_jax_bytes(jx, tmp_path):
    """A bf16 model's state saved and restored by the port, bit for bit; its
    bf16 leaves are stored as the raw two-byte ``|V2`` array that
    ``np.savez`` makes of the JAX package's bfloat16 (the JAX package
    itself cannot restore one: ROADMAP C14)."""
    import dataclasses

    cfg = dataclasses.replace(SMOKE, dtype="bfloat16")
    params = models.init_params(cfg, seed=1)
    st = _state(params)
    st = st._replace(opt=st.opt._replace(step=torch.tensor(
        3, dtype=torch.int32)))
    CheckpointManager(tmp_path, async_write=False).save(3, st)
    template = _state({k: torch.zeros_like(v) for k, v in params.items()})
    _, back = CheckpointManager(tmp_path).restore(template)
    _assert_state_equal(back, st)
    jnp = jx["jnp"]
    np.savez(tmp_path / "j.npz", w=np.asarray(jnp.ones((2, 3), jnp.bfloat16)))
    with np.load(tmp_path / "j.npz") as z, np.load(
            tmp_path / "step_00000003" / "host_0000.npz") as t:
        assert t[".params/embed/embedding"].dtype == z["w"].dtype
        assert z["w"].dtype.kind == "V" and z["w"].dtype.itemsize == 2


def test_restart_resumes_training(tmp_path):
    """Train 2 steps, checkpoint, restore from disk, train 2 more: equal to
    an uninterrupted 4-step run (``test_substrate``'s contract)."""
    want = _trained(4)
    data = SyntheticLM(SMOKE, DataConfig(2, 8))
    fn = make_train_fn(SMOKE, tadamw.AdamWConfig(peak_lr=1e-3))
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(2, _trained(2))
    step0, st = mgr.restore(_state(models.init_params(SMOKE, seed=9)))
    for i in range(step0, 4):
        st, _ = fn(st, _batch(data, i))
    for k, v in want.params.items():
        torch.testing.assert_close(st.params[k], v, rtol=0, atol=1e-6)


# --------------------------------------------------------------- launcher
def test_launcher_trains_checkpoints_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
            "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--log-every", "3"]
    first = subprocess.run(base + ["--steps", "6", "--ckpt-every", "3"],
                           capture_output=True, text=True, env=env,
                           timeout=300)
    assert first.returncode == 0, first.stderr[-2000:]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000006"]
    again = subprocess.run(base + ["--steps", "9", "--resume"],
                           capture_output=True, text=True, env=env,
                           timeout=300)
    assert again.returncode == 0, again.stderr[-2000:]
    out = again.stdout.splitlines()
    assert out[0] == "[train] olmo-1b-smoke: 0.1M params"
    assert out[1] == "[train] resumed from step 6"
    assert re.fullmatch(r"\[train\] step +6 loss \d+\.\d{4} gnorm "
                        r"\d+\.\d{3} lr \d\.\d\de-\d\d", out[2]), out[2]
    assert out[-1] == f"[train] done at step 9; checkpoints in {tmp_path}"
    assert (tmp_path / "step_00000009" / "META.json").exists()
