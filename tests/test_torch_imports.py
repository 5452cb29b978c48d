"""The port stands alone: ``repro_torch`` imports neither jax nor ``repro``."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

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


def test_no_source_file_imports_jax_or_repro():
    offenders = [
        str(p.relative_to(PKG))
        for p in PKG.rglob("*.py")
        if FORBIDDEN.search(p.read_text())
    ]
    assert offenders == []
