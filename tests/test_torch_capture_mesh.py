"""The capture report of a key on a mesh of more than one logical device
(``capture_analysis``, ``Engine._capture_report``; ROADMAP A12 part 3, item
6's collective bytes), against the JAX package's ``analyze_compiled``
report for the same key on 4 fake devices (one subprocess, C16's
``jax.make_mesh`` shim, as ``tests/test_torch_mesh.py``).

Olmo-1b smoke in fp32 (the JAX weights), 4 slots, three engines: an int8
pool at ``1x2`` split with ``1x2@2``, a model-dtype pool at ``2x1`` split
with ``1x1@2`` (both warm ``cbp``, ``pf`` and ``mg`` on each slice), and
``2x2``. Every report is one device's, without ``error``, ``chips`` = the
plan's devices, and its roofline's collective term is its collective bytes
at 900 GB/s. Field by field:

* ``flops`` = the JAX report's, exact (a TP-split product at 1/mp of its
  width on each device, as GSPMD partitions it).
* ``transcendentals`` = the JAX report's plus the sampling draw's
  ``2·S·V·(1 - 1/devices)``: the port gathers the logits and draws once on
  the mesh's first device, GSPMD keeps the Gumbel draw sharded.
* ``collectives``, the result bytes per op type per device:
  - ``all-reduce`` where the plan has one data row = the JAX report's
    (the embedding's and each layer's two ``wo``/``w_down`` reductions, and
    an int8 pool's row-absmax ``pmax``). With two data rows GSPMD adds the
    gather of a slot's pages out of the pool sharded over ``data``, which
    the port reads in the row that holds them: named, held to the port's
    reckoning.
  - ``all-gather`` of ``cbp``/``pf``: the port gathers the vocab-parallel
    logits over ``model`` and the rows' logits over ``data``; GSPMD gathers
    the sampled winners: named, held to the reckoning.
  - ``mg`` gather: at one data row = the JAX report's (the block's heads
    joined over ``model``); at two rows the port gathers both rows' reads
    and selects each page's (bit exact), GSPMD sums the masked reads with an
    all-reduce: named, held to the reckoning. The scatter moves nothing.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch import roofline
from repro_torch.configs import get_config
from repro_torch.core.telemetry import Telemetry
from repro_torch.distributed import sharding as shd
from repro_torch.runtime.serve import Engine, EngineConfig
from test_torch_faults import jaxpkg, tparams  # noqa: F401 (fixtures)
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(max_len=48, batch_quantum=2, max_batch=4, page_size=8,
            num_pages=40, prefill_chunk=8)
SLOTS = 4
# arm: (mesh, the prefill slice or None, pool dtype)
ARMS = {"1x2 int8": ("1x2", "1x2@2", "int8"),
        "2x1 fp32": ("2x1", "1x1@2", "fp32"),
        "2x2 fp32": ("2x2", None, "fp32")}
FIELDS = ("flops", "transcendentals", "collectives", "error")


def reports(make_engine, Telemetry, arm: tuple) -> dict:
    """Every warmed key's report of one arm's paged batcher."""
    mesh, pf, dt = arm
    tel = Telemetry(compile_analysis=True)
    eng = make_engine(mesh, pf, dt, tel)
    eng.paged_continuous(slots=SLOTS, disagg=pf)
    eng.close()
    return {str(r["key"]): r for r in tel.compile_reports}


_SUBPROCESS = """
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
from repro.core.telemetry import Telemetry
from repro.runtime.serve import Engine, EngineConfig

cfg = get_config('olmo-1b').smoke()
params = models.init_params(cfg, jax.random.PRNGKey(0))


def make(mesh, pf, dt, tel):
    reset_entry_points()
    return Engine(cfg, params, EngineConfig(
        mesh=mesh, meshes=(pf,) if pf else (), kv_dtype=dt, **BASE),
        telemetry=tel)


out = {name: {k: {f: r.get(f) for f in FIELDS} for k, r in
              reports(make, Telemetry, arm).items()}
       for name, arm in ARMS.items()}
print('RESULT ' + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_reports():
    pytest.importorskip("jax")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=os.path.join(REPO, "src"),
    )
    code = "\n".join([
        "import json", f"BASE = {BASE!r}", f"SLOTS = {SLOTS!r}",
        f"ARMS = {ARMS!r}", f"FIELDS = {FIELDS!r}",
        inspect.getsource(reports), textwrap.dedent(_SUBPROCESS)])
    out = subprocess.run(
        [sys.executable, "-c", code], env=env,
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _reckoned(cfg, key, mesh: str, dt: str, block: dict) -> dict:
    """The port's collective bytes per device for ``key`` at ``mesh``
    (fp32 activations and logits): the reductions of the embedding and
    each layer's two products, an int8 pool's K and V row-absmax ``pmax``
    a layer, the vocab and rows gathers of the logits; for the ``mg``
    gather the heads' join of the block (``block`` bytes by leaf) and the
    rows' stack."""
    dp, mp, _ = shd.parse_slice_name(mesh)
    lane = key.split("'")[1]
    out: dict = {}
    if lane in ("cbp", "pf"):
        c = 1 if lane == "cbp" else int(key.split(", ")[2])
        rows = SLOTS // dp
        layers, d, v = cfg.num_layers, cfg.d_model, cfg.vocab_size
        if mp > 1:
            out["all-reduce"] = (1 + 2 * layers) * rows * c * d * 4 + (
                2 * layers * rows * c * 4 if dt == "int8" else 0)
        gathered = (rows * v * 4 if mp > 1 else 0) + (
            SLOTS * v * 4 if dp > 1 else 0)
        if gathered:
            out["all-gather"] = gathered
    elif "gather" in key:
        split = sum(n for leaf, n in block.items() if leaf in ("k", "v"))
        gathered = (split if mp > 1 else 0) + (
            dp * sum(block.values()) if dp > 1 else 0)
        if gathered:
            out["all-gather"] = gathered
    return {k: float(n) for k, n in out.items()}


@pytest.mark.parametrize("arm", list(ARMS))
def test_mesh_capture_report_field_by_field(jax_reports, tparams, arm):  # noqa: F811
    cfg = get_config("olmo-1b").smoke()
    mesh, pf, dt = ARMS[arm]

    def make(mesh, pf, dt, tel):
        return Engine(cfg, tparams, EngineConfig(
            mesh=mesh, meshes=(pf,) if pf else (), kv_dtype=dt,
            devices=("cpu",) * 4, **BASE), telemetry=tel, device="cpu")

    got, want = reports(make, Telemetry, ARMS[arm]), jax_reports[arm]
    assert sorted(got) == sorted(want)
    # the block of an mg key: B pages of every leaf at the page cap
    pages, elt = 6, (1 if dt == "int8" else 4)
    kv = 2 * pages * 8 * cfg.num_kv_heads * cfg.head_dim * elt
    block = {"k": kv, "v": kv}
    if dt == "int8":
        block.update(k_scale=2 * pages * 8 * 4, v_scale=2 * pages * 8 * 4)
    named = []
    for key, rep in got.items():
        jrep = want[key]
        m = key.split("'")[-2]
        dp_m, mp_m, _ = shd.parse_slice_name(m)
        devices = dp_m * mp_m
        assert "error" not in rep and jrep.get("error") is None, key
        assert rep["chips"] == devices, key
        assert rep["flops"] == jrep["flops"], key
        lane = key.split("'")[1]
        draw = 2 * SLOTS * cfg.vocab_size if lane in ("cbp", "pf") else 0
        assert rep["transcendentals"] == (
            jrep["transcendentals"] + draw * (1 - 1 / devices)), key
        jc = {k: v for k, v in jrep["collectives"].items() if v}
        reckoned = _reckoned(cfg, key, m, dt, block)
        assert rep["collectives"] == reckoned, (key, rep["collectives"])
        for op in sorted(set(jc) | set(reckoned)):
            if jc.get(op) != reckoned.get(op):
                named.append((lane, m.split("@")[0], op))
        coll = sum(rep["collectives"].values())
        assert rep["collective_bytes_total"] == coll
        assert rep["roofline"]["t_collective_s"] == pytest.approx(
            coll / roofline.NVLINK_BYTES_PER_S)
    # where GSPMD partitions otherwise than the port's explicit layout
    # (the module docstring's reasons); every other field = the JAX report
    dp, mp, _ = shd.parse_slice_name(mesh)
    want_named = set()
    if mp > 1:
        want_named |= {("cbp", mesh, "all-gather"), ("pf", mesh,
                                                     "all-gather")}
    if dp > 1:
        want_named |= {("cbp", mesh, "all-gather"), ("pf", mesh,
                                                     "all-gather"),
                       ("cbp", mesh, "all-reduce"), ("pf", mesh,
                                                     "all-reduce")}
        if pf:
            want_named |= {("mg", mesh, "all-gather"), ("mg", mesh,
                                                        "all-reduce")}
    assert set(named) == want_named
