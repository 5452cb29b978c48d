"""The dry run over ``meta`` meshes (ROADMAP A12 part 3 item 5) against the
JAX package's.

The JAX package's ``run_cell`` runs once, in one subprocess on 8 fake CPU
devices with the ``Auto``-axes shim of ``tests/test_torch_mesh.py``
(ROADMAP C16), on a (2, 2) mesh in place of the production one and the
olmo-1b smoke config, for a train, a prefill and a decode shape of 8 x 32
(its per-device flops are ``hlo_analysis.analyze``'s of the compiled
``lower_for``). The port's ``run_cell`` runs the same cells on a (2, 2)
mesh of ``meta`` devices:

* the record's keys equal the JAX package's, nested ones too; ``chips``,
  ``tokens``, ``model_flops``, ``params_*`` and ``min_bytes_global``
  exactly, ``flops_per_device`` within 10%;
* every argument the lowering builds is on ``meta``;
* the CLI end to end on the 256-device production mesh (olmo-1b
  ``decode_32k``), a refused family's ``error`` record, a skipped shape,
  ``--seq-fallback`` and the MoE flags accepted, ``--save-hlo``;
* ``SHAPES``, ``ASSIGNED`` and ``shape_applicable`` = the JAX package's
  for all 11 configs and 4 shapes;
* every kernel wrapper given ``meta`` tensors raises before any launch.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime import steps
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {"t32": ("train", 32, 8), "p32": ("prefill", 32, 8),
         "d32": ("decode", 32, 8)}
FLOPS_RTOL = 0.10
EXACT = ("chips", "tokens", "model_flops", "params_total", "params_active",
         "min_bytes_global")
ARCHS = tconfigs.ASSIGNED + ("hft-demo",)

_SUBPROCESS = """
import json

import jax
from jax.sharding import AxisType

_make_mesh = jax.make_mesh


def _auto_make_mesh(shape, axes, *a, **k):  # jax 0.9: Explicit by default
    k.setdefault("axis_types", (AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, *a, **k)


jax.make_mesh = _auto_make_mesh
jax.devices()  # the 8 fake devices, before the dry run's 512 flag is set

import repro.launch.dryrun as D
from repro.configs import SHAPES, ShapeSpec, get_config

D.get_config = lambda arch: get_config(arch).smoke()
D.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (2, 2), ("data", "model"), devices=jax.devices()[:4])
for name, (kind, seq, batch) in CELLS.items():
    SHAPES[name] = ShapeSpec(name, kind, seq, batch)
out = {name: D.run_cell("olmo-1b", name, "single") for name in CELLS}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_records():
    pytest.importorskip("jax")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
        PYTHONPATH=os.path.join(REPO, "src"),
    )
    code = f"CELLS = {CELLS!r}\n" + textwrap.dedent(_SUBPROCESS)
    out = subprocess.run(
        [sys.executable, "-c", code], env=env,
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _meta_mesh(dp: int = 2, mp: int = 2):
    return tmesh.make_debug_mesh((dp, mp), devices=["meta"] * (dp * mp))


@pytest.fixture
def small_cells(monkeypatch):
    """The port's dry run on the smoke config over a (2, 2) ``meta`` mesh,
    with the small shapes registered."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch).smoke())
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: _meta_mesh())
    for name, (kind, seq, batch) in CELLS.items():
        monkeypatch.setitem(SHAPES, name, ShapeSpec(name, kind, seq, batch))


def _keys(rec: dict) -> dict:
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in rec.items()}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_record_equals_jax_on_a_small_mesh(jax_records, small_cells, cell):
    want = jax_records[cell]
    got = dryrun.run_cell("olmo-1b", cell, "single")
    assert want["status"] == got["status"] == "ok"
    assert _keys(got) == _keys(want)
    for k in EXACT:
        assert got[k] == want[k], k
    assert got["flops_per_device"] == pytest.approx(
        want["flops_per_device"], rel=FLOPS_RTOL)
    assert got["unknown_trip_whiles"] == 0
    assert got["xla_reported"] == {"flops": got["flops_per_device"],
                                   "bytes_accessed": got["bytes_per_device"]}
    assert got["mem"]["code_bytes"] == 0
    assert got["mem"]["argument_bytes"] > 0 < got["mem"]["temp_bytes"]
    assert got["roofline"]["dominant"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_lowering_allocates_nothing(kind):
    cfg = get_config("olmo-1b").smoke()
    low = steps.lower_for(cfg, _meta_mesh(), ShapeSpec("s", kind, 32, 8))
    tensors = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            tensors.append(node)
        elif hasattr(node, "shards"):
            walk(node.shards)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(low.args)
    assert len(tensors) > 20
    assert {t.device.type for t in tensors} == {"meta"}


def test_cli_decode_on_the_production_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "olmo-1b", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path), "--tag", "pytest"],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[ok] olmo-1b × decode_32k × single" in out.stdout
    rec = json.loads(
        (tmp_path / "olmo-1b--decode_32k--single-pytest.json").read_text())
    assert rec["status"] == "ok"
    assert rec["chips"] == 256
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["tokens"] == 128


def _main(monkeypatch, *argv):
    monkeypatch.setattr(sys, "argv", ["dryrun", *argv])
    dryrun.main()


def test_refused_family_writes_an_error_record(monkeypatch, tmp_path):
    _main(monkeypatch, "--arch", "mamba2-370m", "--shape", "decode_32k",
          "--mesh", "multi", "--out", str(tmp_path))
    rec = json.loads(
        (tmp_path / "mamba2-370m--decode_32k--multi.json").read_text())
    assert rec["status"] == "error"
    assert "NotImplementedError" in rec["error"]
    assert "A12 part 3" in rec["error"]


def test_long_context_is_skipped_with_the_jax_reason():
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import get_config as jax_config
    from repro.configs import shape_applicable as jax_applicable

    rec = dryrun.run_cell("olmo-1b", "long_500k", "single")
    _, why = jax_applicable(jax_config("olmo-1b"), JAX_SHAPES["long_500k"])
    assert rec["status"] == "skipped"
    assert rec["reason"] == why and why


@pytest.mark.parametrize("flag", ["--seq-fallback", "--moe-hints",
                                  "--moe-weight-gather"])
def test_unread_perf_flags_raise(monkeypatch, tmp_path, small_cells, flag):
    """No flag is unread any more: each has its reader
    (``sharding.attn_q_split`` for ``--seq-fallback``,
    ``models.moe.check_mesh_opts`` for the MoE flags) and is accepted, a
    record (qwen3's prefill, granite's decode) with the flag set in
    ``perf_opts`` and an ok status."""
    arch, shape = (("qwen3-14b", "p32") if flag == "--seq-fallback"
                   else ("granite-moe-1b-a400m", "d32"))
    _main(monkeypatch, "--arch", arch, "--shape", shape, "--out",
          str(tmp_path), flag)
    rec = json.loads(
        (tmp_path / f"{arch}--{shape}--single.json").read_text())
    field = {"--seq-fallback": "seq_shard_fallback"}.get(
        flag, flag[2:].replace("-", "_"))
    assert rec["status"] == "ok"
    assert rec["perf_opts"][field] is True


def test_save_hlo_writes_the_counted_op_table(small_cells, tmp_path):
    path = tmp_path / "ops.txt"
    rec = dryrun.run_cell("olmo-1b", "d32", "single", save_hlo=str(path))
    lines = path.read_text().splitlines()
    assert lines[0] == "op calls bytes flops"
    table = {ln.split()[0]: ln.split()[1:] for ln in lines[1:]}
    assert int(table["mm"][0]) > 0 and int(table["mm"][2]) > 0
    assert "op_table" not in rec


def test_shapes_and_assigned_equal_jax():
    from repro import configs as jconfigs

    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    assert set(SHAPES) == set(jconfigs.SHAPES)
    for name, spec in jconfigs.SHAPES.items():
        assert (SHAPES[name].name, SHAPES[name].kind, SHAPES[name].seq_len,
                SHAPES[name].global_batch) == (spec.name, spec.kind,
                                               spec.seq_len, spec.global_batch)
    pairs = 0
    for arch in ARCHS:
        for name in SHAPES:
            assert tconfigs.shape_applicable(
                get_config(arch), SHAPES[name]) == jconfigs.shape_applicable(
                jconfigs.get_config(arch), jconfigs.SHAPES[name]), (arch,
                                                                     name)
            pairs += 1
    assert pairs == 44


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def test_kernel_wrappers_refuse_meta_tensors():
    """The dry run's steps never reach a kernel; one reached with ``meta``
    tensors raises before any build or launch."""
    from repro_torch import kernels

    i32 = torch.int32
    q, pages = _meta(2, 4, 16), _meta(8, 8, 2, 16)
    qc = _meta(2, 3, 4, 16)
    bt, pos = _meta(2, 4, dtype=i32), _meta(2, dtype=i32)
    qi, sc = _meta(8, 8, 2, 16, dtype=torch.int8), _meta(8, 8)
    dense, fq = _meta(2, 2, 32, 16), _meta(2, 4, 32, 16)
    calls = {
        "paged_decode_attention": lambda: kernels.paged_decode_attention(
            q, pages, pages, bt, pos),
        "paged_prefill_attention": lambda: kernels.paged_prefill_attention(
            qc, pages, pages, bt, pos),
        "paged_decode_attention_int8":
            lambda: kernels.paged_decode_attention_int8(
                q, qi, qi, sc, sc, bt, pos),
        "paged_prefill_attention_int8":
            lambda: kernels.paged_prefill_attention_int8(
                qc, qi, qi, sc, sc, bt, pos),
        "decode_attention": lambda: kernels.decode_attention(
            q, dense, dense, _meta(dtype=i32)),
        "flash_attention": lambda: kernels.flash_attention(fq, fq, fq),
        "flash_attention_branchy": lambda: kernels.flash_attention_branchy(
            fq, fq, fq, _meta(3, dtype=i32)),
        "ssd_chunk": lambda: kernels.ssd_chunk(
            _meta(1, 16, 2, 8), _meta(1, 16, 1, 4), _meta(1, 16, 1, 4),
            _meta(1, 16, 2), _meta(2), chunk=8),
        "sample_rows": lambda: kernels.sample_rows(
            _meta(2, 16), _meta(2), _meta(2, dtype=torch.bool),
            _meta(2, 2, dtype=i32)),
    }
    before = [k.launches for k in kernels.KERNELS]
    assert len(calls) == len(before)
    for name, call in calls.items():
        with pytest.raises(ValueError, match="expected CUDA tensors"):
            call()
    assert [k.launches for k in kernels.KERNELS] == before
