"""Specialisation tables and shape buckets for semi-static dispatch keys
(from ``repro.core.specialization``).

``SpecTable`` is a key -> branch target table filled on the cold path and
read with a plain dict hit on the hot path: a thin layer over
``core.dispatch.CompileCache`` (single-flight builds, optional bound).
``kernels.ops.KernelBranch`` keeps its mode-specialised kernels in one.
"""

from __future__ import annotations

from .dispatch import CompileCache


class SpecTable(CompileCache):
    """key -> branch target, with single-flight cold-path fill."""

    def __init__(self, name: str = "spec", capacity: int | None = None):
        super().__init__(name=name, capacity=capacity)


def bucket_pow2(n: int, lo: int, hi: int) -> int:
    """Round up to a power-of-two bucket in [lo, hi] (serving shape buckets)."""
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


def bucket_multiple(n: int, quantum: int, hi: int) -> int:
    """Round up to a multiple of ``quantum`` (decode batch buckets)."""
    b = ((n + quantum - 1) // quantum) * quantum
    return min(max(b, quantum), hi)
