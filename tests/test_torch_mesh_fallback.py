"""Context-parallel attention (``perf.seq_shard_fallback``) and the
embeddings-input family on meshes of logical devices (ROADMAP A12 part 3
item 6, part 2) against the JAX package on the same weights and inputs.

The JAX package runs once, in one subprocess started with the module (8
fake CPU devices, one thread, the ``Auto``-axes shim of
``tests/test_torch_mesh.py`` in this test's code, ROADMAP C16), while the
port's own checks run. Smoke configs in fp32, a batch of 8 rows of 32
tokens or, for an embeddings arch, of 32 seeded ``[D]`` embeddings; labels
with pads spread unevenly over the rows. Per case and per value of the
flag, with its ``lower_for`` executables:

* prefill's last-token logits, one decode step on the emitted cache (the
  last position rewritten) and the train step's loss, ``ce`` and
  ``grad_norm`` = the port's within 1e-5;
* the cases: qwen3, internvl2 and musicgen smoke (4 heads, 2 kv heads) at
  1 x 8, where the heads do not divide ``model`` (the fallback splits the
  query sequence); internvl2 with 14 heads at 2 x 4 (data rows beside the
  split); musicgen at 2 x 2, where they divide (the heads split, the
  vocab over ``model``: the head's ``vocab`` branch); internvl2 with a
  255-entry vocab at 2 x 2 (its head's width over ``("data", "model")``:
  the ``width`` branch); a 36-token prompt at 1 x 8 (36 % 8 != 0: the
  fallback falls back to replicated); gemma2 smoke at 1 x 8 (local windows
  of 16 under the split: each shard's frontier is global).

The port alone: each flagged result = the unflagged one within 2e-4 (the
JAX package's own ``test_seq_fallback_semantics_on_mesh``); the decision
(``sharding.attn_q_split``) over a table; the head branches at full size;
the dry run's qwen3/internvl2/musicgen smoke cells at 1 x 8 against the
JAX package's ``run_cell`` with and without the flag (train and prefill
flops equal; decode's named difference: GSPMD splits a sequence-split
cache's attention over ``model``, the port runs it whole on every shard,
ROADMAP C17); every assigned arch's record ``ok`` but mamba2's and
jamba's; the continuous engines refusing an embeddings arch on a mesh
with the JAX package's ``ValueError``.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import subprocess
import sys
import textwrap
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch import perf
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import spmd
from repro_torch.optim import adamw
from repro_torch.runtime import steps
from repro_torch.runtime.serve import Engine, EngineConfig
from test_torch_mesh import BASE, CPU4, REPO
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

ATOL = 1e-5  # fp32 against the JAX package: the same sums in another order
FALLBACK_ATOL = 2e-4  # the JAX package's own flagged-vs-unflagged bound
FLOPS_RTOL = 0.10
B = 8
# name: (config, mesh dims, sequence length, fallback values, what runs)
CASES = {
    "qwen3 1x8": ("qwen3", (1, 8), 32, (False, True), "pdt"),
    "internvl2 1x8": ("internvl2", (1, 8), 32, (False, True), "pdt"),
    "musicgen 1x8": ("musicgen", (1, 8), 32, (False, True), "pdt"),
    "internvl2h14 2x4": ("internvl2h14", (2, 4), 32, (False, True), "pdt"),
    "musicgen 2x2": ("musicgen", (2, 2), 32, (False, True), "pdt"),
    "internvl2w 2x2": ("internvl2w", (2, 2), 32, (False,), "pdt"),
    "internvl2 1x8 s36": ("internvl2", (1, 8), 36, (False, True), "p"),
    "gemma2 1x8": ("gemma2", (1, 8), 32, (False, True), "pt"),
}
DRY_ARCHS = ("qwen3-14b", "internvl2-1b", "musicgen-medium")
CELLS = {"t32": ("train", 32, 8), "p32": ("prefill", 32, 8),
         "d32": ("decode", 32, 8)}
DRY_DIMS = (1, 8)


def configs(get_config, replace) -> dict:
    """The compared configs, built alike in both packages."""
    iv = get_config("internvl2-1b").smoke()
    return {"qwen3": get_config("qwen3-14b").smoke(), "internvl2": iv,
            "internvl2h14": replace(iv, num_heads=14, num_kv_heads=2),
            "internvl2w": replace(iv, vocab_size=255),
            "musicgen": get_config("musicgen-medium").smoke(),
            "gemma2": get_config("gemma2-27b").smoke()}


def arrays(cfg, seq: int) -> dict:
    """Seeded inputs (tokens, or float32 embeddings), labels with pads
    (from position 5 of row 0, all of row 6) and the decode step's
    input."""
    rng = np.random.default_rng(seq)
    if cfg.input_kind == "tokens":
        inputs = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
        step = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    else:
        inputs = rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32)
        step = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    labels[0, 5:] = -1
    labels[6, :] = -1
    return {"inputs": inputs, "labels": labels, "step": step}


_SUBPROCESS = """
import json
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

_make_mesh = jax.make_mesh


def _auto_make_mesh(shape, axes, *a, **k):  # jax 0.9: Explicit by default
    k.setdefault("axis_types", (AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, *a, **k)


jax.make_mesh = _auto_make_mesh
jax.devices()  # the 8 fake devices, before the dry run's 512 flag is set

import repro.launch.dryrun as D
from repro import models, perf
from repro.configs import SHAPES, ShapeSpec, get_config
from repro.optim import adamw
from repro.runtime import steps

CFGS = configs(get_config, replace)
OUT = sys.argv[1]
out = {}


def flat(tree):
    return {'.'.join(str(getattr(k, 'key', getattr(k, 'idx', k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


saved = set()
for name, (cname, dims, seq, fbs, runs) in CASES.items():
    cfg = CFGS[cname]
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    if cname not in saved:
        np.savez(f'{OUT}/{cname}.npz', **flat(params))
        saved.add(cname)
    n = dims[0] * dims[1]
    mesh = jax.make_mesh(dims, ('data', 'model'), devices=jax.devices()[:n])
    a = arrays(cfg, seq)
    for fb in fbs:
        opts = perf.PerfOpts(seq_shard_fallback=fb)
        res = {}
        if 'p' in runs:
            exe = steps.lower_for(cfg, mesh, ShapeSpec('p', 'prefill', seq, B),
                                  opts=opts).compile()
            logits, cache = exe(params, a['inputs'])
            res['prefill'] = np.asarray(logits)
            if 'd' in runs:
                exe = steps.lower_for(
                    cfg, mesh, ShapeSpec('d', 'decode', seq, B), opts=opts,
                    donate=False).compile()
                res['decode'] = np.asarray(exe(params, cache, a['step'],
                                               jnp.int32(seq - 1))[0])
        if 't' in runs:
            exe = steps.lower_for(cfg, mesh, ShapeSpec('t', 'train', seq, B),
                                  opts=opts, donate=False).compile()
            state = steps.place_train_state(cfg, steps.TrainState(
                params=params, opt=adamw.init(params)), mesh)
            batch = {k: jax.device_put(a[k], NamedSharding(mesh, P('data')))
                     for k in ('inputs', 'labels')}
            _, m = exe(state, batch)
            res.update({f'train {k}': np.asarray(v) for k, v in m.items()})
        np.savez(f'{OUT}/{name} {fb}.npz', **res)

D.get_config = lambda arch: get_config(arch).smoke()
D.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    DRY_DIMS, ('data', 'model'), devices=jax.devices()[:8])
for cell, (kind, seq, b) in CELLS.items():
    SHAPES[cell] = ShapeSpec(cell, kind, seq, b)
for arch in DRY_ARCHS:
    for cell in CELLS:
        for fb in (False, True):
            out[f'{arch} {cell} {fb}'] = D.run_cell(
                arch, cell, 'single',
                opts=perf.PerfOpts(seq_shard_fallback=fb))
print('RESULT ' + json.dumps(out))
"""


class _Job:
    """The JAX subprocess, started on first use; ``result()`` waits for
    it."""

    def __init__(self, out_dir):
        env = dict(  # one thread: it runs beside the suite's workers
            os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
            XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                      "--xla_cpu_multi_thread_eigen=false "
                      "intra_op_parallelism_threads=1",
            PYTHONPATH=os.path.join(REPO, "src"),
        )
        code = "\n".join([
            "import numpy as np", f"B = {B!r}", f"CASES = {CASES!r}",
            f"DRY_ARCHS = {DRY_ARCHS!r}", f"CELLS = {CELLS!r}",
            f"DRY_DIMS = {DRY_DIMS!r}", inspect.getsource(configs),
            inspect.getsource(arrays), textwrap.dedent(_SUBPROCESS)])
        self.out_dir = out_dir
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code, str(out_dir)], env=env, cwd=REPO,
            text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        self._out = None

    def result(self) -> dict:
        if self._out is None:
            stdout, stderr = self.proc.communicate(timeout=900)
            assert self.proc.returncode == 0, stderr[-3000:]
            line = next(x for x in stdout.splitlines()
                        if x.startswith("RESULT "))
            self._out = json.loads(line[len("RESULT "):])
        return self._out

    def arrays(self, name: str) -> dict:
        self.result()
        with np.load(self.out_dir / f"{name}.npz") as z:
            return {k: z[k] for k in z.files}

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module")
def jax_job(tmp_path_factory):
    if importlib.util.find_spec("jax") is None:
        pytest.skip("JAX is not installed")
    job = _Job(tmp_path_factory.mktemp("jax_mesh_fallback"))
    yield job
    job.close()


@pytest.fixture(scope="module", autouse=True)
def _start_jax_job(request):
    """Start the JAX job before the port's own checks, which run while it
    does (where JAX is missing, the tests that need it skip)."""
    try:
        request.getfixturevalue("jax_job")
    except pytest.skip.Exception:
        pass


@pytest.fixture(scope="module")
def cfgs():
    return configs(get_config, replace)


def _mesh(dims, device: str = "cpu"):
    return tmesh.make_debug_mesh(dims, ("data", "model"),
                                 devices=[device] * (dims[0] * dims[1]))


@pytest.fixture(scope="module")
def port_runs(cfgs):
    """The port's results of each (case, flag), on the port's own seeded
    weights (the checks that compare the port with itself) or, given
    ``params``, on the JAX package's; memoised per weights."""
    memo: dict = {}

    def run(name: str, fb: bool, params: dict | None = None) -> dict:
        key = (name, fb, params is None)
        if key in memo:
            return memo[key]
        from repro_torch import models

        cname, dims, seq, _, runs = CASES[name]
        cfg = cfgs[cname]
        if params is None:
            params = models.init_params(cfg, seed=0)
        mesh = _mesh(dims)
        a = {k: torch.from_numpy(v) for k, v in arrays(cfg, seq).items()}
        opts = perf.PerfOpts(seq_shard_fallback=fb)
        state = steps.place_train_state(cfg, steps.TrainState(
            params=params, opt=adamw.init(params)), mesh)
        res = {}
        if "p" in runs:
            logits, cache = steps.lower_for(
                cfg, mesh, ShapeSpec("p", "prefill", seq, B),
                opts=opts).compile()(state.params, a["inputs"])
            res["prefill"] = logits.numpy()
            if "d" in runs:
                res["decode"] = steps.lower_for(
                    cfg, mesh, ShapeSpec("d", "decode", seq, B),
                    opts=opts).compile()(
                    state.params, cache, a["step"],
                    torch.tensor(seq - 1, dtype=torch.int32))[0].numpy()
        if "t" in runs:
            _, m = steps.lower_for(
                cfg, mesh, ShapeSpec("t", "train", seq, B), opts=opts,
                donate=False).compile()(
                state, {k: a[k] for k in ("inputs", "labels")})
            res.update({f"train {k}": v.numpy() for k, v in m.items()})
        memo[key] = res
        return res

    return run


def _jparams(jax_job, cname: str) -> dict:
    """The JAX package's seeded weights of a config, as the port's."""
    return {k: torch.from_numpy(v.copy())
            for k, v in jax_job.arrays(cname).items()}


PAIRS = [(name, fb) for name, c in CASES.items() for fb in c[3]]


# ------------------------------------------------ against the JAX package
@pytest.mark.parametrize("name,fb", PAIRS,
                         ids=[f"{n}-{'on' if f else 'off'}" for n, f in PAIRS])
def test_steps_equal_jax(jax_job, port_runs, name, fb):
    """Prefill logits, one decode step's logits and the train step's
    metrics = the JAX package's executables' at the same mesh and flag."""
    want = jax_job.arrays(f"{name} {fb}")
    got = port_runs(name, fb, _jparams(jax_job, CASES[name][0]))
    assert sorted(got) == sorted(want)
    for k in ("prefill", "decode"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                       err_msg=k)
    for k in ("loss", "ce", "grad_norm", "ntok"):
        if f"train {k}" in want:
            np.testing.assert_allclose(got[f"train {k}"], want[f"train {k}"],
                                       rtol=0, atol=ATOL, err_msg=k)


# ------------------------------------------------------------ the port
@pytest.mark.parametrize(
    "name", [n for n, c in CASES.items() if len(c[3]) == 2])
def test_fallback_equals_unflagged(port_runs, name):
    """The JAX package's ``test_seq_fallback_semantics_on_mesh``: the flag
    changes no result beyond the order of sums."""
    off, on = port_runs(name, False), port_runs(name, True)
    assert sorted(off) == sorted(on)
    for k in off:
        np.testing.assert_allclose(on[k], off[k], rtol=0,
                                   atol=FALLBACK_ATOL, err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3", "gemma2"])
def test_chunked_attention_under_the_fallback(cfgs, arch):
    """The online-softmax attention (``impl="chunked"``, key blocks of 8)
    under the split at 1 x 8: each shard's queries at their global
    positions (gemma2's windows of 16 too) = one device's naive
    ``prefill`` within 1e-5, and the train step's loss = one device's."""
    from repro_torch import models

    cfg = cfgs[arch]
    params = models.init_params(cfg, seed=0)
    a = {k: torch.from_numpy(v) for k, v in arrays(cfg, 32).items()}
    mesh = _mesh((1, 8))
    opts = perf.PerfOpts(seq_shard_fallback=True, attn_block=8)
    state = steps.place_train_state(cfg, steps.TrainState(
        params=params, opt=adamw.init(params)), mesh)
    got, _ = steps.lower_for(cfg, mesh, ShapeSpec("p", "prefill", 32, B),
                             impl="chunked", opts=opts).compile()(
        state.params, a["inputs"])
    want, _ = models.prefill(cfg, params, a["inputs"], impl="naive")
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    batch = {k: a[k] for k in ("inputs", "labels")}
    _, m = steps.lower_for(cfg, mesh, ShapeSpec("t", "train", 32, B),
                           impl="chunked", opts=opts, donate=False).compile()(
        state, batch)
    loss, _ = models.loss_fn(cfg, params, batch)
    torch.testing.assert_close(m["loss"], loss, atol=ATOL, rtol=0)


def test_attn_q_split_is_hint_attn_q_s_decision():
    """Heads where ``model`` divides them; else the sequence with the flag
    where ``model`` divides it; else replicated (and nothing on one
    device)."""
    table = [  # (heads, seq, mp, fallback) -> split
        ((4, 32, 2, False), "heads"), ((4, 32, 2, True), "heads"),
        ((4, 32, 8, False), None), ((4, 32, 8, True), "seq"),
        ((4, 36, 8, True), None), ((40, 32768, 16, True), "seq"),
        ((40, 32768, 16, False), None), ((14, 512, 4, True), "seq"),
        ((24, 4096, 16, True), "seq"), ((32, 32, 16, True), "heads"),
        ((4, 32, 1, True), None),
    ]
    for (h, s, mp, fb), want in table:
        assert shd.attn_q_split(h, s, mp, fb) == want, (h, s, mp, fb)
    with perf.use_perf_opts(perf.PerfOpts(seq_shard_fallback=True)):
        assert shd.attn_q_split(4, 32, 8) == "seq"
    assert shd.attn_q_split(4, 32, 8) is None


def test_rows_split_their_queries_only_in_full_sequence_attention(cfgs):
    """``spmd``'s rows take ``seq_q`` from the decision: on for a 1 x 8
    prefill or loss of 32 rows under the flag, off at 36 rows and without
    it, never for decode (no ``seq``); never where the heads split."""
    from repro_torch import models

    cfg = cfgs["qwen3"]
    mesh = _mesh((1, 8), "meta")
    shapes = models.init_params(cfg, device="meta")
    p_spec, _ = fsdp.state_specs(cfg, shapes, mesh)
    uspecs = fsdp.use_specs(p_spec)
    params = {c: {} for c in mesh.coords()}
    with perf.use_perf_opts(perf.PerfOpts(seq_shard_fallback=True)):
        flags = {s: [r.seq_q for _, r in spmd._rows_of(
            cfg, mesh, params, uspecs, seq=s)] for s in (32, 36, None)}
    assert flags == {32: [True], 36: [False], None: [False]}
    assert not spmd.layout(cfg, uspecs, mesh).heads
    mesh2 = _mesh((1, 2), "meta")
    p2, _ = fsdp.state_specs(cfg, shapes, mesh2)
    u2 = fsdp.use_specs(p2)
    with perf.use_perf_opts(perf.PerfOpts(seq_shard_fallback=True)):
        rows2 = list(spmd._rows_of(cfg, mesh2, {c: {} for c in
                                                mesh2.coords()}, u2, seq=32))
    assert spmd.layout(cfg, u2, mesh2).heads
    assert [r.seq_q for _, r in rows2] == [False]


@pytest.mark.parametrize("arch,dims,want", [
    ("internvl2w", (2, 2), (False, True)),  # 255 % 2: d_model split
    ("musicgen", (2, 2), (True, False)),
    ("internvl2", (1, 8), (True, False)),
    ("internvl2-1b", (2, 4), (False, True)),  # 151655 = 5 x 30331
    # 896 % 256 != 0: the width over data alone, the head whole on every
    # model shard (the JAX package's rules give the same)
    ("internvl2-1b", (16, 16), (False, False)),
    ("musicgen-medium", (16, 16), (True, False)),  # 2048 over 16
])
def test_head_branches_of_the_embeddings_archs(cfgs, arch, dims, want):
    """With no table, the head's spec sets the split: (vocab, width) for
    the training rules and the serving plan alike."""
    from repro_torch import models
    from repro_torch.models import tensor_parallel as tp

    cfg = cfgs.get(arch) or get_config(arch)
    assert cfg.input_kind == "embeddings"
    shapes = models.init_params(cfg, device="meta")
    mesh = _mesh(dims, "meta")
    p_spec, _ = fsdp.state_specs(cfg, shapes, mesh)
    lay = spmd.layout(cfg, fsdp.use_specs(p_spec), mesh)
    assert (lay.vocab, lay.width) == want
    assert "embed.embedding" not in shapes
    if want[1]:  # FSDP puts the width over both axes
        assert p_spec["head.lm_head"] == (("data", "model"), None)
    plan = shd.MeshPlan(shd.mesh_name(*dims), ["meta"] * (dims[0] * dims[1]))
    slay = tp.layout_for(cfg, plan.param_specs(shapes), plan, 4, 8)
    assert (slay.vocab, slay.width) == want


# --------------------------------------------------------------- dry run
@pytest.fixture
def small_cells(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch).smoke())
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: _mesh(DRY_DIMS, "meta"))
    from repro_torch.configs import SHAPES

    for name, (kind, seq, batch) in CELLS.items():
        monkeypatch.setitem(SHAPES, name, ShapeSpec(name, kind, seq, batch))


@pytest.mark.parametrize("fb", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_dry_run_flops_equal_jax(jax_job, small_cells, arch, cell, fb):
    """A device's flops = ``hlo_analysis``'s of the JAX package's
    ``lower_for`` within 10% (train and prefill: equal, with the flag too:
    the port projects K over its rows and V whole, as GSPMD partitions the
    reference). Decode does not read the flag; there the port attends the
    gathered sequence-split cache whole on every shard where GSPMD splits
    the scores over ``model``: ``(1 - 1/mp)`` of the attention's flops more
    (ROADMAP C17)."""
    want = jax_job.result()[f"{arch} {cell} {fb}"]
    got = dryrun.run_cell(arch, cell, "single",
                          opts=perf.PerfOpts(seq_shard_fallback=fb))
    assert want["status"] == got["status"] == "ok"
    assert got["perf_opts"]["seq_shard_fallback"] is fb
    assert want["perf_opts"]["seq_shard_fallback"] is fb
    kind, seq, batch = CELLS[cell]
    cfg = get_config(arch).smoke()
    if kind == "decode":
        mp = DRY_DIMS[1]
        attn = cfg.num_layers * 2 * 2 * batch * cfg.num_heads * seq * (
            cfg.head_dim)
        assert got["flops_per_device"] - want["flops_per_device"] == (
            attn * (mp - 1) // mp)
    else:
        assert got["flops_per_device"] == pytest.approx(
            want["flops_per_device"], rel=FLOPS_RTOL)
    gathers = got["collective_bytes_per_device"]["all-gather"]
    if fb and kind != "decode":  # K and the rows joined each layer
        assert gathers >= cfg.num_layers * batch * seq * (
            cfg.num_kv_heads * cfg.head_dim + cfg.d_model) * 4


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_embeddings_archs_dry_run_on_a_mesh(small_cells, arch):
    """Each kind's record is ``ok`` on a 1 x 8 ``meta`` mesh; the SSM and
    hybrid archs stay refused (``tests/test_torch_mesh_moe.py``)."""
    for cell in CELLS:
        rec = dryrun.run_cell(arch, cell, "single")
        assert rec["status"] == "ok", rec
        assert rec["flops_per_device"] > 0


def test_continuous_engines_refuse_an_embeddings_arch_on_a_mesh(cfgs):
    """The JAX package's ``ValueError`` from both continuous engines, on a
    plan of more than one device as on one."""
    from repro_torch import models

    cfg = cfgs["internvl2"]
    params = models.init_params(cfg, seed=0)
    for mesh in ("1x2", "2x2"):
        for engine in ("paged_continuous", "continuous"):
            with Engine(cfg, params, EngineConfig(**BASE, mesh=mesh,
                                                  devices=CPU4),
                        device="cpu") as eng:
                with pytest.raises(ValueError, match="token-input arch"):
                    getattr(eng, engine)(slots=4)
