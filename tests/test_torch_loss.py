"""``models.loss_fn`` and ``runtime.steps.make_train_fn`` against the JAX
package's (CPU, fp32 smoke configs, the port's seeded weights in both, batches from the
synthetic pipeline, a quarter of the labels padded): olmo-1b (also under
``impl="chunked"``), gemma2-27b (window, softcaps), mamba2-370m (the SSD
scan's backward), granite-moe-1b-a400m (the aux term under each MoE
policy), jamba-1.5-large-398b (hybrid) and internvl2-1b (embeddings in).
The JAX train step is jitted once per case and run for three steps, which
both comparisons read. The loss and its metrics within 1e-5 relative of
the JAX step's first, every gradient (the JAX step's, read back from its
first moment and clip scale) within 1e-4 relative plus 5e-5 of the leaf's largest (fp32
sums in other orders through up to 8 layers); three train steps' losses
within 1e-5 relative, params within 1e-4, a tenth of one step at lr 1e-3
(AdamW's step g / (|g| + eps) is of order lr even where g is at the
rounding floor, so a gradient that is pure rounding noise moves its
parameter by a part of lr that differs between the libraries), and the
moments within 1e-3 relative plus 2e-4 of the leaf's largest (the later
steps' gradients are taken at those parameters, and nu squares them).
Port only: the gradients are the same with remat off and under
``remat_policy`` "full" and "dots" ("dots" recomputing no matrix product,
"full" recomputing them); the kernels refuse an input that requires a
gradient under grad mode (before any launch), and ``loss_fn`` with ``impl="kernel"``
raises ``ValueError``."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels, models, perf
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.steps import TrainState, make_train_fn
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-4
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
CASES = [
    ("olmo-1b", "naive", "drop"),
    ("olmo-1b", "chunked", "drop"),
    ("gemma2-27b", "naive", "drop"),
    ("mamba2-370m", "naive", "drop"),
    ("granite-moe-1b-a400m", "naive", "drop"),
    ("granite-moe-1b-a400m", "naive", "dense"),
    ("granite-moe-1b-a400m", "naive", "gather"),
    ("jamba-1.5-large-398b", "naive", "drop"),
    ("internvl2-1b", "naive", "drop"),
]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro import models as jm
    from repro.configs import get_config as jax_config
    from repro.optim import adamw as jadamw
    from repro.runtime import steps as jsteps

    return dict(jax=jax, models=jm, config=jax_config, adamw=jadamw,
                steps=jsteps, weights={}, runs={})


def port_weights_as_jax(jax, jmodels, jcfg, tp: dict):
    """The port's params ``tp`` in the JAX package's tree for ``jcfg``
    (its ``init_params`` traced for the structure only: drawing eagerly
    compiles each of its ops, ~12 s for jamba's smoke config)."""
    shapes = jax.eval_shape(lambda: jmodels.init_params(
        jcfg, jax.random.PRNGKey(0)))
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    return jax.tree_util.tree_unflatten(tree, [
        jax.numpy.asarray(tp[".".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path
        )].numpy()) for path, _ in leaves])


def _setup(jx, arch: str):
    """(port cfg, JAX cfg, JAX params, port params, data); the port's
    seeded weights, in both packages, made once per arch."""
    jax = jx["jax"]
    cfg, jcfg = get_config(arch).smoke(), jx["config"](arch).smoke()
    if arch not in jx["weights"]:
        jx["weights"][arch] = port_weights_as_jax(
            jax, jx["models"], jcfg, models.init_params(cfg, seed=0))
    jp = jx["weights"][arch]
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    data = SyntheticLM(cfg, DataConfig(2, 16, seed=5, pad_frac=0.25))
    return cfg, jcfg, jp, tp, data


def _tbatch(data, step: int) -> dict:
    return {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}


def _close(got: torch.Tensor, want, rtol: float, what: str,
           floor: float = 5e-5) -> None:
    """Within ``rtol`` plus ``floor`` of the largest element."""
    want = torch.from_numpy(np.asarray(want))
    atol = floor * float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}: {m}")


def _port_grads(cfg, params, batch, **kw):
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss, metrics = models.loss_fn(cfg, leaves, batch, **kw)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                materialize_grads=True)
    return loss.detach(), metrics, dict(zip(leaves, grads))


def _jax_run(jx, arch: str, impl: str, policy: str) -> list:
    """The JAX package's train step, jitted once per case, run for three
    steps from the JAX weights: [(state, metrics)] after each step."""
    key = (arch, impl, policy)
    if key not in jx["runs"]:
        cfg, jcfg, jp, tp, data = _setup(jx, arch)
        jfn = jx["jax"].jit(jx["steps"].make_train_fn(
            jcfg, jx["adamw"].AdamWConfig(**OPT), impl=impl,
            moe_policy=policy))
        js = jx["steps"].TrainState(params=jp, opt=jx["adamw"].init(jp))
        out = []
        for i in range(3):
            js, jm = jfn(js, data.batch_at(i))
            out.append((js, jm))
        jx["runs"][key] = out
    return jx["runs"][key]


def _jax_grads(jx, run: list) -> dict:
    """Step 1's gradients, read back from its first moment: from mu = 0,
    mu = (1 - b1) * scale * g, with the clip scale of that step's norm."""
    cfg = jx["adamw"].AdamWConfig(**OPT)
    js, jm = run[0]
    scale = min(1.0, cfg.clip_norm / max(float(jm["grad_norm"]), 1e-9))
    mu = params_from_jax(jx["jax"].tree.map(np.asarray, js.opt.mu))
    return {k: m / ((1 - cfg.b1) * scale) for k, m in mu.items()}


@pytest.mark.parametrize("arch, impl, policy", CASES)
def test_loss_and_grads_equal_jax(jx, arch, impl, policy):
    """The port's ``loss_fn`` and its gradients at the first batch against
    the JAX step's first loss, metrics and gradients (one JAX compile per
    case, shared with the three-step test)."""
    cfg, jcfg, jp, tp, data = _setup(jx, arch)
    run = _jax_run(jx, arch, impl, policy)
    jm = run[0][1]
    tl, tm, tg = _port_grads(cfg, tp, _tbatch(data, 0), impl=impl,
                             moe_policy=policy)
    np.testing.assert_allclose(float(tl), float(jm["loss"]), rtol=LOSS_RTOL)
    for k in ("ce", "moe_aux", "ntok"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    assert float(tm["ntok"]) == 24  # 2 rows x 12 of 16 labels valid
    if cfg.num_experts:
        assert float(tm["moe_aux"]) > 0
    flat = _jax_grads(jx, run)
    assert set(flat) == set(tg)
    for k, g in flat.items():
        _close(tg[k], g, GRAD_RTOL, f"grad {k}")


@pytest.mark.parametrize("arch, impl, policy",
                         [c for c in CASES if c[2] == "drop"])
def test_three_train_steps_equal_jax(jx, arch, impl, policy):
    cfg, jcfg, jp, tp, data = _setup(jx, arch)
    jax = jx["jax"]
    run = _jax_run(jx, arch, impl, policy)
    tfn = make_train_fn(cfg, tadamw.AdamWConfig(**OPT), impl=impl,
                        moe_policy=policy)
    ts = TrainState(params=tp, opt=tadamw.init(tp))
    for i, (js, jm) in enumerate(run):
        ts, tm = tfn(ts, _tbatch(data, i))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=GRAD_RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(ts.opt.step) == 3
    js = run[-1][0]
    for name, got, want in (("params", ts.params, js.params),
                            ("mu", ts.opt.mu, js.opt.mu),
                            ("nu", ts.opt.nu, js.opt.nu)):
        flat = params_from_jax(jax.tree.map(np.asarray, want))
        for k, w in flat.items():
            if name == "params":
                torch.testing.assert_close(got[k], w, rtol=0, atol=PARAM_ATOL)
            else:
                _close(got[k], w, 1e-3, f"{name} {k}", floor=2e-4)


class _CountProducts(TorchDispatchMode):
    """Counts the matrix products dispatched while it is active."""

    def __init__(self) -> None:
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m",
                                  "granite-moe-1b-a400m"])
def test_remat_changes_no_gradient(arch):
    """Remat off, "full" and "dots" (``perf``'s ``remat_policy``): the same
    loss and gradients, bit for bit. The backward of "full" recomputes the
    forward's matrix products; "dots" keeps them, so its backward runs as
    many products as without remat."""
    cfg = get_config(arch).smoke()
    params = models.init_params(cfg, seed=1)
    data = SyntheticLM(cfg, DataConfig(2, 16, seed=2))
    batch = _tbatch(data, 0)
    runs = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        with perf.use_perf_opts(perf.PerfOpts(remat_policy=policy)):
            leaves = {k: p.detach().requires_grad_()
                      for k, p in params.items()}
            loss, _ = models.loss_fn(cfg, leaves, batch, remat=remat)
            count = _CountProducts()
            with count:
                grads = torch.autograd.grad(loss, list(leaves.values()))
        runs[remat, policy] = (loss.detach(), grads, count.n)
    want_l, want, off = runs[False, "full"]
    for key, (got_l, got, _) in runs.items():
        assert torch.equal(got_l, want_l), key
        assert all(torch.equal(a, b) for a, b in zip(got, want)), key
    assert runs[True, "dots"][2] == off < runs[True, "full"][2]


def test_kernels_refuse_a_gradient():
    """B6, B7 and B8 raise ``ValueError`` when grad mode is on and an input
    requires a gradient, before the CPU's plain version (and on the card
    before a launch); not under ``torch.no_grad`` or without such an
    input. ``loss_fn`` with ``impl="kernel"`` raises."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 8, 16, generator=g)
    k, v = torch.randn(1, 2, 8, 16, generator=g), torch.randn(1, 2, 8, 16,
                                                              generator=g)
    x, b = torch.randn(1, 8, 2, 16, generator=g), torch.randn(1, 8, 1, 16,
                                                              generator=g)
    dt, a = torch.rand(1, 8, 2, generator=g), -torch.rand(2, generator=g)
    flags = torch.tensor([1, 0, 0], dtype=torch.int32)
    calls = {
        "flash_attention": (lambda t: kernels.flash_attention(t, k, v), q),
        "flash_attention_branchy": (
            lambda t: kernels.flash_attention_branchy(t, k, v, flags), q),
        "ssd_chunk": (lambda t: kernels.ssd_chunk(t, b, b, dt, a, chunk=4),
                      x),
    }
    for name, (call, t) in calls.items():
        call(t)  # no input requires a gradient
        with torch.no_grad():
            call(t.clone().requires_grad_())
        with pytest.raises(ValueError, match=f"{name}: .*impl='naive'"):
            call(t.clone().requires_grad_())
    for arch in ("olmo-1b", "mamba2-370m"):
        cfg = get_config(arch).smoke()
        data = SyntheticLM(cfg, DataConfig(1, 8))
        with pytest.raises(ValueError, match="no backward"):
            _port_grads(cfg, models.init_params(cfg, seed=0),
                        _tbatch(data, 0), impl="kernel")
