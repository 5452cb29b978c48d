"""The port stands alone: ``repro_torch`` imports neither jax nor ``repro``."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


def test_importing_every_module_leaves_jax_and_repro_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'repro') "
        "or m.startswith(('jax.', 'jaxlib.', 'repro.')))\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr


# the modules this slice of the port added: each must stand alone
SLICE_MODULES = (
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.ops",
    "repro_torch.core.specialization",
)


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_imports_alone_without_jax_or_repro(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'repro') "
        "or m.startswith(('jax.', 'jaxlib.', 'repro.')))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert not FORBIDDEN.search((PKG / (module.split(".", 1)[1].replace(
        ".", "/") + ".py")).read_text())


def test_no_source_file_imports_jax_or_repro():
    offenders = [
        str(p.relative_to(PKG))
        for p in PKG.rglob("*.py")
        if FORBIDDEN.search(p.read_text())
    ]
    assert offenders == []


def test_chip_smoke_imports_neither_jax_nor_repro():
    smoke = PKG.parents[1] / "chip_smoke.py"
    assert not FORBIDDEN.search(smoke.read_text())
    assert "import repro_torch" in smoke.read_text()


def test_every_kernel_source_is_built():
    """Each CUDA source of the package has a build entry, and every
    kernel's entry point is bound."""
    from repro_torch.kernels import build

    sources = {p.name for p in (PKG / "csrc").glob("*.cu")}
    assert sources == set(build.SOURCES)
    assert {
        "paged_decode_attention_int8", "paged_prefill_attention_int8",
        "dense_decode_attention", "flash_attention", "flash_attention_branchy",
    } <= {fn for fns in build.SOURCES.values() for fn in fns}


# the modules of the SSM slice: each must stand alone
SSM_SLICE_MODULES = (
    "repro_torch.models.ssm",
    "repro_torch.kernels.ssd_chunk",
    "repro_torch.configs.mamba2_370m",
)


@pytest.mark.parametrize("module", SSM_SLICE_MODULES)
def test_ssm_slice_module_imports_alone_without_jax_or_repro(module):
    test_slice_module_imports_alone_without_jax_or_repro(module)


def test_ssd_kernel_source_is_built_and_bound():
    from repro_torch.kernels import build

    assert "ssd_chunk" in build.SOURCES["ssd_chunk.cu"]
    assert (PKG / "csrc" / "ssd_chunk.cu").exists()
