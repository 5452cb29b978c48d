"""Serving mesh plans: the port's copy of the mesh-name and plan half of
``repro.distributed.sharding`` (DESIGN.md §16-§17).

The serving engine treats the device topology as a dispatch coordinate:
every lane that touches a pool carries a trailing ``mesh`` name ("1x1",
"1x1@1", ... = data x model [@ device offset]), warmed like any bucket
ladder, so a topology change at run time is a copy of the live state into
the target cell's buffers plus a hot-slot flip, never a capture.

The port runs one-device plans only: ``"1x1"`` (the engine's own device)
and offset slices ``"1x1@OFF"``, each pinned to ``devices[OFF]`` of the
engine's logical device list (``EngineConfig.devices``). Two slices may
name one card: the disaggregated split then runs both halves on it, and
page migration is a device-local copy. A plan of more than one device
(``dp * mp > 1``: tensor-parallel params, pools sharded over ``data``)
waits for ROADMAP A12 part 2, as do the param and cache spec rules and the
``hint`` of the JAX package; an engine raises ``NotImplementedError``
where it would warm or bind such a plan.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Sequence

SERVING_AXES = ("data", "model")

MULTI_DEVICE_WAITS = (
    "meshes of more than one device wait for ROADMAP A12 part 2 "
    "(tensor-parallel params, pools sharded over 'data')"
)


def parse_mesh_name(name: str) -> tuple[int, int]:
    """"2x2" / "2,2" -> (dp, mp). Offset slice names ("1x1@1") parse to the
    same (dp, mp) shape; ``parse_slice_name`` keeps the offset."""
    return parse_slice_name(name)[:2]


def parse_slice_name(name: str) -> tuple[int, int, int]:
    """"DPxMP[@OFF]" -> (dp, mp, off): an ordinary DPxMP mesh placed at
    device offset OFF (DESIGN.md §17). Plain names carry offset 0."""
    body, _, off_s = str(name).strip().lower().partition("@")
    parts = re.split(r"[x,]", body)
    if len(parts) != 2:
        raise ValueError(
            f"mesh name must be 'DPxMP[@OFF]' (e.g. '1x2', '1x1@1'), "
            f"got {name!r}"
        )
    try:
        dp, mp = int(parts[0]), int(parts[1])
        off = int(off_s) if off_s else 0
    except ValueError as e:
        raise ValueError(
            f"mesh name must be 'DPxMP[@OFF]', got {name!r}"
        ) from e
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {name!r}")
    if off < 0:
        raise ValueError(f"mesh offset must be >= 0, got {name!r}")
    return dp, mp, off


def mesh_name(dp: int, mp: int, off: int = 0) -> str:
    return f"{dp}x{mp}" if off == 0 else f"{dp}x{mp}@{off}"


class MeshPlan:
    """One serving-mesh coordinate over the engine's logical devices.

    ``single`` plans ("1x1") run on the engine's own device, the exact
    pre-mesh path. One-device offset slices ("1x1@1") are ``solo``: pinned
    to ``devices[off]``. ``device`` raises ``ValueError`` for a slice whose
    offset lies past ``devices`` (no missing device is mapped onto another
    without being told to) and ``NotImplementedError`` for a plan of more
    than one device."""

    def __init__(self, name: str, devices: Sequence[str] = ()):
        self.dp, self.mp, self.offset = parse_slice_name(name)
        self.name = mesh_name(self.dp, self.mp, self.offset)
        self.devices = tuple(devices)

    @property
    def single(self) -> bool:
        return self.dp == 1 and self.mp == 1 and self.offset == 0

    @property
    def solo(self) -> bool:
        """One device at any offset."""
        return self.dp == 1 and self.mp == 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.mp

    @property
    def device(self) -> str:
        """The device a solo plan is pinned to."""
        if not self.solo:
            raise NotImplementedError(f"mesh {self.name!r}: "
                                      f"{MULTI_DEVICE_WAITS}")
        avail = len(self.devices)
        if self.offset >= avail:
            raise ValueError(
                f"mesh {self.name!r} needs device {self.offset}, only "
                f"{avail} listed ({self.devices}); list more in "
                f"EngineConfig.devices (one device may be named twice)"
            )
        return self.devices[self.offset]

    def __repr__(self) -> str:
        return f"MeshPlan({self.name!r})"


@dataclass(frozen=True)
class DisaggPlan:
    """Disaggregated prefill/decode placement (DESIGN.md §17): the prefill
    lanes (``LaneSpec.slice == "prefill"``) pin to ``prefill``, everything
    else to ``decode``. Both names must sit in the engine's warmed mesh
    ladder; the split is then a rebind (``set_disagg``), never a capture.
    The two slices' device offsets must not overlap."""

    prefill: str
    decode: str

    def __post_init__(self) -> None:
        pf, dec = MeshPlan(self.prefill), MeshPlan(self.decode)
        pf_devs = set(range(pf.offset, pf.offset + pf.num_devices))
        dec_devs = set(range(dec.offset, dec.offset + dec.num_devices))
        if pf_devs & dec_devs:
            raise ValueError(
                f"disagg slices overlap: prefill {self.prefill!r} and "
                f"decode {self.decode!r} share devices "
                f"{sorted(pf_devs & dec_devs)}"
            )
        object.__setattr__(self, "prefill", pf.name)
        object.__setattr__(self, "decode", dec.name)

    @classmethod
    def split(cls, base: "MeshPlan | str") -> "DisaggPlan":
        """The canonical split of a base mesh: its last data-parallel row
        becomes the prefill slice, the rest keep decoding ("2x1" -> decode
        "1x1" + prefill "1x1@1")."""
        plan = base if isinstance(base, MeshPlan) else MeshPlan(base)
        if plan.dp < 2:
            raise ValueError(
                f"disagg split needs dp >= 2 on the base mesh, got "
                f"{plan.name!r} (one data row must become the prefill slice)"
            )
        dec_dp = plan.dp - 1
        return cls(
            prefill=mesh_name(1, plan.mp, plan.offset + dec_dp * plan.mp),
            decode=mesh_name(dec_dp, plan.mp, plan.offset),
        )
