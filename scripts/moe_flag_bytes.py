#!/usr/bin/env python3
"""The dry run's counts a device for a MoE config on a (2, 2) mesh, with
and without each MoE flag (``--moe-hints``, ``--moe-weight-gather``): the
JAX package's ``run_cell`` (in a subprocess on 4 fake CPU devices, with
``jax.make_mesh`` given ``Auto`` axes, as ``tests/test_torch_mesh.py``
does) beside the port's (a (2, 2) mesh of ``meta`` devices).

Run from the root of a checkout, on the CPU (JAX must be installed for
the reference's column):

    PYTHONPATH=src python scripts/moe_flag_bytes.py \\
        [--arch granite-moe-1b-a400m] [--shape train_4k]

Prints a table (flops and collective bytes by op type a device, per flag)
and, last, one JSON object with every record's numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLAGS = {"none": {}, "moe_hints": {"moe_hints": True},
         "moe_weight_gather": {"moe_weight_gather": True}}
OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute")

_REFERENCE = """
import json
import sys

import jax
from jax.sharding import AxisType

_make_mesh = jax.make_mesh


def _auto_make_mesh(shape, axes, *a, **k):  # jax 0.9: Explicit by default
    k.setdefault("axis_types", (AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, *a, **k)


jax.make_mesh = _auto_make_mesh
jax.devices()

import repro.launch.dryrun as D
from repro import perf

D.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (2, 2), ('data', 'model'), devices=jax.devices()[:4])
out = {}
for name, kw in FLAGS.items():
    rec = D.run_cell(ARCH, SHAPE, 'single',
                     opts=perf.from_flags(**kw) if kw else None)
    out[name] = {k: rec.get(k) for k in
                 ('status', 'flops_per_device', 'collective_bytes_per_device',
                  'error')}
print('RESULT ' + json.dumps(out))
"""


def reference(arch: str, shape: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    code = (f"ARCH = {arch!r}\nSHAPE = {shape!r}\nFLAGS = {FLAGS!r}\n"
            + textwrap.dedent(_REFERENCE))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    line = next(x for x in out.stdout.splitlines()
                if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def port(arch: str, shape: str) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import perf
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh

    dryrun.make_production_mesh = lambda multi_pod=False: make_debug_mesh(
        (2, 2), devices=["meta"] * 4)
    out = {}
    for name, kw in FLAGS.items():
        rec = dryrun.run_cell(arch, shape, "single",
                              opts=perf.from_flags(**kw) if kw else None)
        out[name] = {k: rec.get(k) for k in
                     ("status", "flops_per_device",
                      "collective_bytes_per_device", "error")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args()
    recs = {"reference": reference(args.arch, args.shape),
            "port": port(args.arch, args.shape)}
    print(f"{args.arch} {args.shape} on a (2, 2) mesh, a device's counts")
    print("| package | flag | flops | " + " | ".join(OPS) + " |")
    for pkg, by_flag in recs.items():
        for flag, rec in by_flag.items():
            coll = rec["collective_bytes_per_device"] or {}
            print(f"| {pkg} | {flag} | {rec['flops_per_device']} | "
                  + " | ".join(str(coll.get(op, 0)) for op in OPS) + " |")
    print(json.dumps(recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
