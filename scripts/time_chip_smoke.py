#!/usr/bin/env python3
"""Run ``chip_smoke.py`` with a timer around each of its functions, to see
where the script's time goes.

Run from the root of a checkout, on the machine with the GPU:

    python3 scripts/time_chip_smoke.py [--out chiprun_out/chip_smoke_times.txt]
    python3 scripts/time_chip_smoke.py --only moe_mesh_phase  # one phase

``--only NAME`` runs ``setup()`` (the kernels' build) and then the one
phase function ``NAME`` of ``chip_smoke`` instead of the whole script
(a phase that reads another's result takes no ``--only``).

Every function of ``chip_smoke`` (and the engine's ``__init__``,
``paged_continuous``, ``continuous``, ``_build``, ``_warm_lanes`` and
``_capture_report``) is wrapped: its inclusive seconds are summed over the
calls that are not nested in another call of itself. Each log line gains
the seconds since the start (``@  123.4``). The table, most seconds
first, goes to ``--out`` (seconds, calls, name). The script's own checks
and exit code are unchanged; the wrappers cost well under a second.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

ENGINE_METHODS = ("__init__", "paged_continuous", "continuous", "_build",
                  "_warm_lanes", "_capture_report")


def _timed(owner, name: str, label: str, seconds: dict, calls: dict,
           depth: dict) -> None:
    fn = getattr(owner, name)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        depth[label] = depth.get(label, 0) + 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            depth[label] -= 1
            if depth[label] == 0:
                seconds[label] = (seconds.get(label, 0.0)
                                  + time.perf_counter() - t0)
                calls[label] = calls.get(label, 0) + 1

    setattr(owner, name, wrapper)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/chip_smoke_times.txt")
    ap.add_argument("--only", default=None,
                    help="a phase function of chip_smoke to run alone, "
                         "after setup()")
    args = ap.parse_args()
    seconds, calls, depth = {}, {}, {}
    for name, fn in list(vars(chip_smoke).items()):
        if (inspect.isfunction(fn) and fn.__module__ == "chip_smoke"
                and name not in ("log", "check", "main")):
            _timed(chip_smoke, name, name, seconds, calls, depth)
    if chip_smoke.torch.cuda.is_available():
        from repro_torch.runtime.serve import Engine

        for name in ENGINE_METHODS:
            _timed(Engine, name, f"Engine.{name}", seconds, calls, depth)
    t0 = time.perf_counter()
    log = chip_smoke.log
    chip_smoke.log = lambda msg: log(f"@{time.perf_counter() - t0:7.1f} {msg}")
    try:
        if args.only is None:
            return chip_smoke.main()
        if not chip_smoke.torch.cuda.is_available():
            raise SystemExit("--only needs a CUDA device")
        chip_smoke.setup()
        t1 = time.perf_counter()
        getattr(chip_smoke, args.only)()
        chip_smoke.log(f"[only] {args.only} passed in "
                       f"{time.perf_counter() - t1:.1f}s")
        return 0
    finally:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("".join(
            f"{s:9.2f} {calls[k]:6d} {k}\n"
            for k, s in sorted(seconds.items(), key=lambda kv: -kv[1])))


if __name__ == "__main__":
    sys.exit(main())
