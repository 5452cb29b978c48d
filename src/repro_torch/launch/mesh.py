"""Production and debug meshes (the port's copy of ``repro.launch.mesh``).

Functions, not module-level constants, so importing this module touches no
device. A production mesh is over ``meta`` devices: it allocates nothing,
and the spec rules (``distributed.sharding``) resolve against it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.distributed.sharding import LogicalMesh


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The 16x16 ("data", "model") mesh, or 2x16x16 with a "pod" axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    return LogicalMesh(shape, axes, ["meta"] * n)


def make_debug_mesh(shape: Sequence[int] = (2, 2),
                    axes: Sequence[str] = ("data", "model"),
                    devices: Sequence[str | torch.device] | None = None
                    ) -> LogicalMesh:
    """A small mesh over ``devices``: logical devices on one card, or on
    the CPU in tests. With no ``devices`` every coordinate is ``cuda:0``,
    and without a card that raises ``RuntimeError`` (there is no silent
    CPU fallback); the CPU is used only where the caller names it
    (``devices=["cpu"] * n``)."""
    n = 1
    for s in shape:
        n *= s
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_debug_mesh: no CUDA device; pass devices=['cpu'] * "
                f"{n} for a mesh of logical devices on the CPU")
        devices = ["cuda:0"] * n
    return LogicalMesh(shape, axes, devices)
