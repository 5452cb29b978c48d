"""Dispatch-coordinate registry: lanes and their bucket axes as declarations.

The port's copy of ``repro.core.lanes`` (DESIGN.md §12), holding the lanes
the paged serving path runs: ``cbp`` (paged decode) and ``pf`` (chunked
paged prefill).

* ``LaneAxis``    — one coordinate of a lane's key: a name plus the *bucket
                    ladder* that enumerates its warmup fan-out (an engine
                    method name, e.g. ``"_chunk_buckets"``), or ``None``
                    for axes the caller pins per batcher (``slots``).
* ``LaneSpec``    — one lane's declaration: name, role (stats grouping),
                    ordered axes, and the engine hook names that build
                    (``builder``), dummy-run (``warmer``), and gate
                    (``enabled``) its branch targets. ``fanout`` expands
                    the axis ladders into the complete warmup key set.
* ``DispatchKey`` — the typed key: a tuple subclass ``(lane, *coords)``.
* ``LaneRegistry``— name -> spec, with ``spec_for(key)`` raising
                    ``UnknownLaneError`` on unregistered lanes or arity
                    mismatches — a loud cold-path error, never a silent skip.

The registry holds *declarations only* (method names, not callables), so it
imports nothing heavier than the stdlib and carries no reference to a live
engine. The JAX package's ``kv_dtype`` and ``mesh`` coordinates join the
keys when int8 pages and the multi-device layer are ported.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Hashable, Iterable

from .dispatch import DispatchError


class UnknownLaneError(DispatchError):
    """An unregistered lane name (or malformed key) reached the dispatcher.

    Raised at build/warmup time: before the registry, an unrecognised key
    prefix fell through ``runtime/serve.py``'s sniffing chain silently."""


class DispatchKey(tuple):
    """Typed dispatch key ``(lane, coord_0, ..., coord_{n-1})``.

    A tuple subclass so it hashes and compares exactly like the raw tuples
    it replaces (compile caches, pinned-slot bookkeeping, and stats keys
    are unchanged), while giving the registry and reports structured
    access to the lane name and coordinates.
    """

    __slots__ = ()

    def __new__(cls, lane: str, coords: Iterable[Hashable] = ()):
        return super().__new__(cls, (lane, *coords))

    @property
    def lane(self) -> str:
        return self[0]

    @property
    def coords(self) -> tuple:
        return tuple(self[1:])

    def __repr__(self) -> str:  # debuggable: DispatchKey('pf', 4, 16, 'int8')
        return f"DispatchKey({self[0]!r}, {self.coords!r})"


@dataclass(frozen=True)
class LaneAxis:
    """One coordinate axis of a lane's dispatch key.

    ``ladder`` names the engine method returning the axis's warmup fan-out
    (ordered bucket values, e.g. the log-sized chunk set {8, 16, ...});
    ``None`` marks an axis the caller pins per warmup (``slots`` — chosen
    at batcher-creation time, not derivable from the engine config alone).
    """

    name: str
    ladder: str | None = None

    def values(self, engine: Any) -> tuple:
        if self.ladder is None:
            raise UnknownLaneError(
                f"axis {self.name!r} has no ladder; pin it via fanout(..., "
                f"{self.name}=value)"
            )
        return tuple(getattr(engine, self.ladder)())


@dataclass(frozen=True)
class LaneSpec:
    """One lane's declaration: key shape + engine hooks, no live state.

    ``builder``/``warmer``/``enabled`` are *engine method names* — the
    registry stays declarative and importable anywhere; the engine supplies
    behaviour. ``engines`` says which warmup drivers iterate this spec
    ({"dense"}, {"paged"}, {"burst"}, or combinations); ``role`` groups the
    lane in per-lane reports (prefill/draft/verify/decode/burst).
    """

    name: str
    role: str
    axes: tuple[LaneAxis, ...]
    builder: str
    warmer: str | None = None
    engines: frozenset[str] = field(default_factory=frozenset)
    enabled: str | None = None
    doc: str = ""

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    def key(self, *coords: Hashable) -> DispatchKey:
        """Build this lane's typed key; arity-checked at construction."""
        if len(coords) != len(self.axes):
            raise UnknownLaneError(
                f"lane {self.name!r} takes {len(self.axes)} coordinates "
                f"{self.axis_names}, got {len(coords)}: {coords!r}"
            )
        return DispatchKey(self.name, coords)

    def coords(self, key: tuple) -> tuple:
        """Validate ``key`` against this spec and return its coordinates."""
        if len(key) != len(self.axes) + 1:
            raise UnknownLaneError(
                f"lane {self.name!r} key must be (name, {', '.join(self.axis_names)}), "
                f"got {tuple(key)!r}"
            )
        return tuple(key[1:])

    def fanout(self, engine: Any, **pinned: Hashable) -> list[DispatchKey]:
        """The lane's complete warmup key set: the cartesian product of
        every axis's ladder, with ``pinned`` axes held at one value. This
        is what makes "add a coordinate" one declaration: a new axis
        automatically multiplies into every lane that carries it."""
        extra = set(pinned) - set(self.axis_names)
        if extra:
            raise UnknownLaneError(
                f"lane {self.name!r}: pinned unknown axes {sorted(extra)} "
                f"(axes: {self.axis_names})"
            )
        ranges = [
            ((pinned[a.name],) if a.name in pinned else a.values(engine))
            for a in self.axes
        ]
        return [self.key(*combo) for combo in itertools.product(*ranges)]


class LaneRegistry:
    """Name -> ``LaneSpec``; the single source of truth for the key space."""

    def __init__(self) -> None:
        self._specs: dict[str, LaneSpec] = {}

    def register(self, spec: LaneSpec) -> LaneSpec:
        if spec.name in self._specs:
            raise UnknownLaneError(
                f"lane {spec.name!r} registered twice; lane names are the "
                f"dispatch namespace and must be unique"
            )
        self._specs[spec.name] = spec
        return spec

    def get(self, name: str) -> LaneSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise UnknownLaneError(
                f"unknown lane {name!r}; registered lanes: "
                f"{sorted(self._specs)}"
            ) from None

    def spec_for(self, key: Hashable) -> LaneSpec:
        """Resolve a dispatch key to its spec, arity-validated.

        This is the warmup/build-time gate: raw tuples with unregistered
        prefixes (or the wrong coordinate count) raise ``UnknownLaneError``
        instead of falling through a sniffing chain.
        """
        if not isinstance(key, tuple) or not key or not isinstance(key[0], str):
            raise UnknownLaneError(
                f"dispatch key must be (lane_name, *coords), got {key!r}"
            )
        spec = self.get(key[0])
        spec.coords(key)  # arity check
        return spec

    def for_engine(self, kind: str) -> list[LaneSpec]:
        """Specs a given engine kind warms, in registration (= warm) order."""
        return [s for s in self._specs.values() if kind in s.engines]

# --------------------------------------------------------------- the registry
# The serving engine's lanes (DESIGN.md §12). Registration order IS warmup
# order per engine kind: decode capacity first, then prompt ingestion.
LANES = LaneRegistry()

_SLOTS = LaneAxis("slots")  # pinned per batcher (paged_continuous(slots=...))
_PAGES = LaneAxis("pages_bucket", "_pages_buckets")
_CHUNK = LaneAxis("chunk_bucket", "_chunk_buckets")

CBP = LANES.register(LaneSpec(
    name="cbp", role="decode",
    axes=(_SLOTS, _PAGES),
    builder="_build_paged_slot_decode", warmer="_warm_cbp",
    engines=frozenset({"paged"}),
    doc="Paged continuous decode: the capacity bucket as a semi-static "
        "coordinate (DESIGN.md §9).",
))

PF = LANES.register(LaneSpec(
    name="pf", role="prefill",
    axes=(_SLOTS, _CHUNK),
    builder="_build_paged_prefill", warmer="_warm_pf",
    engines=frozenset({"paged"}), enabled="_supports_chunked_prefill",
    doc="Paged chunked prefill, batched: every prefilling slot the budget "
        "covers rides one call (DESIGN.md §10).",
))
