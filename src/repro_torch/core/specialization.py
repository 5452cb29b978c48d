"""Specialisation tables and shape buckets for semi-static dispatch keys
(from ``repro.core.specialization``).

``SpecTable`` is a key -> branch target table filled on the cold path and
read with a plain dict hit on the hot path: a thin layer over
``core.dispatch.CompileCache`` (single-flight builds, optional bound), with
the historical interface (``get``/``get_or_build``/``prewarm``/``stats``).
``kernels.ops.KernelBranch`` keeps its mode-specialised kernels in one.
"""

from __future__ import annotations

from typing import Hashable

import torch
from torch.utils import _pytree as pytree

from .dispatch import CacheStats, CompileCache

# Backwards-compatible alias: SpecTable.stats used to be a SpecStats.
SpecStats = CacheStats


class SpecTable(CompileCache):
    """key -> branch target, with single-flight cold-path fill."""

    def __init__(self, name: str = "spec", capacity: int | None = None):
        super().__init__(name=name, capacity=capacity)

    def prewarm(self, key: Hashable, args: tuple) -> None:
        """Run an already-built entry on dummy inputs and wait for its
        device work (the BTB-warming analogue); raises KeyError if the key
        was never built."""
        out = self.get(key)(*args)
        devices = {
            t.device for t in pytree.tree_leaves(out)
            if isinstance(t, torch.Tensor) and t.device.type == "cuda"
        }
        for d in devices:
            torch.cuda.synchronize(d)


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
