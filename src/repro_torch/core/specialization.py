"""Shape buckets for semi-static dispatch keys (from ``repro.core.specialization``)."""

from __future__ import annotations


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
