"""The other dense configs on meshes of logical devices (ROADMAP A12 part 3
item 6, part 4): qwen3-14b (qk_norm), gemma2-27b (alternating local
windows, attention and final softcaps, a tied table with ``embed_scale``),
hft-demo (every layer local, window 128) and deepseek-67b, each held to the
JAX package on the same weights and requests.

The JAX package's streams run once, in one subprocess started with the
module (4 fake CPU devices, one thread, the ``Auto``-axes shim of
``tests/test_torch_mesh.py``, ROADMAP C16), which also writes each config's
seeded weights; the port runs on ``devices=("cpu",) * 4``, one torch
thread. Smoke configs in fp32 (window 16 for gemma2 and hft-demo), 4 slots,
page 8, chunked prefill 8, ``max_len`` 64; 6 greedy requests of 24-token
prompts and 8 new tokens, so every stream runs past the windows.

* The paged stream at 1x2 and 2x2: tokens, lane steps and ``pool_shards``
  = the JAX package's at the same mesh, 0 builds after warmup.
* One ``cbp`` step's and one ``pf`` chunk's logits at 1x2 and 2x2 within
  1e-5 of 1x1's (``tests/test_torch_mesh_moe.py``'s harness).
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.serve import Engine, EngineConfig, run_paged_stream
from test_torch_mesh import BASE, CPU4, REPO
from test_torch_mesh_moe import _step_logits
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

ARCHS = ("qwen3-14b", "gemma2-27b", "hft-demo", "deepseek-67b")
MESHES = ("1x2", "2x2")
LONG = dict(BASE, max_len=64, num_pages=40)


def greedy_stream(Request, vocab: int, n: int = 6) -> list:
    """24-token prompts, 8 new tokens, greedy."""
    rng = np.random.default_rng(0)
    return [Request(rid=i, new_tokens=8, greedy=True, temperature=1.0,
                    arrival_s=0.0,
                    prompt=tuple(int(x) for x in rng.integers(0, vocab, 24)))
            for i in range(n)]


_SUBPROCESS = """
import json
import os
import sys

import jax
from jax.sharding import AxisType

_make_mesh = jax.make_mesh


def _auto_make_mesh(shape, axes, *a, **k):  # jax 0.9: Explicit by default
    k.setdefault("axis_types", (AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, *a, **k)


jax.make_mesh = _auto_make_mesh

from repro import models
from repro.configs import get_config
from repro.core import reset_entry_points
from repro.runtime.scheduler import Request
from repro.runtime.serve import Engine, EngineConfig, run_paged_stream

OUT = sys.argv[1]
out = {}
for arch in ARCHS:
    cfg = get_config(arch).smoke()
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    flat = {'.'.join(str(getattr(k, 'key', getattr(k, 'idx', k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(f'{OUT}/{arch}.tmp.npz', **flat)
    os.replace(f'{OUT}/{arch}.tmp.npz', f'{OUT}/{arch}.npz')
    for mesh in MESHES:
        reset_entry_points()
        eng = Engine(cfg, params, EngineConfig(mesh=mesh, **LONG))
        rs = greedy_stream(Request, cfg.vocab_size)
        rep = run_paged_stream(eng, rs, slots=4)
        out[f'{arch} {mesh}'] = dict(
            tokens=[list(r.tokens) for r in rs],
            lane_steps=rep['lane_steps'],
            pool_shards=rep.get('pool_shards'),
            compiles=rep['compiles_after_warmup'])
        eng.close()
print('RESULT ' + json.dumps(out))
"""


class _Job:
    """The JAX subprocess, started with the module; ``result()`` waits for
    it, ``params(arch)`` only for that config's weights."""

    def __init__(self, out_dir):
        env = dict(  # one thread: it runs beside the suite's workers
            os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
            XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                      "--xla_cpu_multi_thread_eigen=false "
                      "intra_op_parallelism_threads=1",
            PYTHONPATH=os.path.join(REPO, "src"),
        )
        code = "\n".join([
            "import numpy as np", f"ARCHS = {ARCHS!r}",
            f"MESHES = {MESHES!r}", f"LONG = {LONG!r}",
            inspect.getsource(greedy_stream), textwrap.dedent(_SUBPROCESS)])
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

    def params(self, arch: str) -> dict:
        path = self.out_dir / f"{arch}.npz"
        while not path.exists():
            if self.proc.poll() is not None:
                self.result()  # raises with the subprocess's error
                assert path.exists(), arch
            time.sleep(0.1)
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k].copy()) for k in z.files}

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module")
def jax_job(tmp_path_factory):
    if importlib.util.find_spec("jax") is None:
        pytest.skip("JAX is not installed")
    job = _Job(tmp_path_factory.mktemp("jax_mesh_dense"))
    yield job
    job.close()


@pytest.fixture(scope="module", autouse=True)
def _start_jax_job(request):
    """Start the JAX job before the port's own checks (where JAX is
    missing, the tests that need it skip)."""
    try:
        request.getfixturevalue("jax_job")
    except pytest.skip.Exception:
        pass


@pytest.mark.parametrize("arch", ARCHS)
def test_step_logits_at_1x2_and_2x2_equal_1x1(arch):
    """fp32 within 1e-5, on the port's own seeded weights: the heads and
    kv heads split over ``model`` (4 and 2 over 2), softcaps, windows and
    qk_norm on each shard."""
    from repro_torch import models

    cfg = get_config(arch).smoke()
    out = _step_logits(cfg, models.init_params(cfg, seed=0), "drop")
    for m in MESHES:
        for lane, got, want in zip(("cbp", "pf"), out[m], out["1x1"]):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0,
                                       msg=f"{m} {lane}")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_stream_equals_jax(jax_job, arch, mesh):
    cfg = get_config(arch).smoke()
    with Engine(cfg, jax_job.params(arch),
                EngineConfig(**LONG, mesh=mesh, devices=CPU4),
                device="cpu") as eng:
        rs = greedy_stream(Request, cfg.vocab_size)
        rep = run_paged_stream(eng, rs, slots=4)
    want = jax_job.result()[f"{arch} {mesh}"]
    assert [list(r.tokens) for r in rs] == want["tokens"]
    assert all(len(r.tokens) == 8 for r in rs)
    assert rep["lane_steps"] == want["lane_steps"]
    assert rep["pool_shards"] == want["pool_shards"]
    assert rep["compiles_after_warmup"] == 0 == want["compiles"]
    assert rep["mesh"] == mesh
