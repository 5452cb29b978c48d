"""JAX's threefry PRNG in PyTorch: the part of ``jax.random`` the serving
steps reach (counterpart of ``jax._src.prng`` and ``jax._src.random`` in
jax 0.9.0, with ``jax_threefry_partitionable`` on and
``jax_default_prng_impl`` ``threefry2x32``, as that release runs).

A key is a ``[..., 2]`` tensor of uint32 bit patterns stored as int32, the
way the JAX package bit-casts its keys into a step's packed pull. The
arithmetic runs in int64 masked to 32 bits (``torch.uint32`` arithmetic is
partial on both CPU and CUDA), so every function here gives JAX's bits
exactly:

* ``threefry2x32`` — the Threefry-2x32 hash (20 rounds, 5 key injections;
  ``_threefry2x32_lowering``).
* ``split(keys, n)`` — ``jax.random.split``: key ``i`` is the hash of the
  64-bit counter ``i`` (``_threefry_split_foldlike``).
* ``random_bits(keys, bit_width, shape)`` — each element hashes the 64-bit
  counter of its flat index within ``shape``, as ``(hi, lo)`` words
  (``iota_2x32_shape``), and keeps ``bits1 ^ bits2``, truncated to 16 or 8
  bits for narrower widths (``_threefry_random_bits_partitionable``).
* ``uniform`` / ``gumbel`` / ``categorical`` — ``jax.random``'s
  ``_uniform``, ``_gumbel`` (``mode=None``, i.e. "low") and
  ``categorical`` (``replace=True``: the Gumbel-max trick).

Floating point follows XLA's CPU lowering of those functions, read from the
compiled HLO (``jax.jit(f).lower(...).compile().as_text()``): every
elementwise op of a bfloat16 computation is computed in float32 and rounded
to bfloat16 after each op (a ``convert`` pair between every two ops — the
uniform's ``- 1``, its ``+ minval``, the ``max``, each ``log`` and each
negation, the logits' division by the temperature and the gumbel's add).
A bfloat16 uniform draws 8 random bits, not 16: ``_uniform`` takes
``rng_bits = 8`` where the mantissa has fewer than 8 bits (bfloat16 has 7),
truncates ``bits1 ^ bits2`` to its low byte and keeps its top 7 bits as the
mantissa, so a bfloat16 gumbel takes one of 128 values. ``log`` is the one
op whose last bit may differ between XLA's and PyTorch's (or CUDA's)
implementations; everything else here is exact.

This module is the plain version of the sampling kernel
(``repro_torch.kernels.sampling``) and the CPU path.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

MASK = 0xFFFFFFFF
# Threefry-2x32 rotations, alternating by group of four rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# smallest normal of float32 and bfloat16 alike: the gumbel's minval
TINY = torch.finfo(torch.float32).tiny


def _u32(keys: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or int64 words) -> int64 in [0, 2^32)."""
    return keys.to(torch.int64) & MASK


def to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the same bits as int32."""
    return (((words + 2**31) & MASK) - 2**31).to(torch.int32)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter words ``(x1, x2)`` under the
    key ``(k1, k2)``: int64 tensors holding uint32 values, broadcast
    together; returns the two output words the same way."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1, x2 = torch.broadcast_tensors(x1 + ks[0], x2 + ks[1])
    x1, x2 = x1 & MASK, x2 & MASK  # fresh tensors, updated in place below
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1.add_(x2).bitwise_and_(MASK)
            x2.copy_(((x2 << r) | (x2 >> (32 - r))).bitwise_and_(MASK))
            x2.bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x2.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK)
    return x1, x2


def _hash_counters(keys: torch.Tensor, count: int):
    """Hash the 64-bit counters ``0 .. count-1`` under each key of
    ``keys [..., 2]``: two ``[..., count]`` int64 word tensors."""
    idx = torch.arange(count, dtype=torch.int64, device=keys.device)
    k = _u32(keys)
    return threefry2x32(k[..., 0:1], k[..., 1:2], idx >> 32, idx & MASK)


def split(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split`` of each key: ``[..., 2]`` -> ``[..., n, 2]``
    int32."""
    b1, b2 = _hash_counters(keys, n)
    return to_int32(torch.stack([b1, b2], dim=-1))


def random_bits(keys: torch.Tensor, bit_width: int,
                shape: Sequence[int]) -> torch.Tensor:
    """``bit_width`` (8, 16 or 32) random bits per element of ``shape``
    under each key of ``keys [..., 2]``: an int64 ``[..., *shape]`` of the
    unsigned values."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16 or 32, got {bit_width}")
    shape = tuple(int(d) for d in shape)
    b1, b2 = _hash_counters(keys, math.prod(shape))
    bits = b1 ^ b2
    if bit_width < 32:
        bits = bits & ((1 << bit_width) - 1)
    return bits.reshape(*keys.shape[:-1], *shape)


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One op's result in ``dtype``, carried as float32: XLA's CPU lowering
    computes each bfloat16 op in float32 and rounds it (module docstring)."""
    if dtype == torch.float32:
        return x
    return x.to(dtype).to(torch.float32)


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")


def _log(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` correctly rounded (computed in float64): within one
    ulp of XLA's, and the same on every device and at every position of a
    tensor (PyTorch's float32 ``log`` on the CPU is not: its vector and
    scalar paths differ, and a tensor's split between them varies)."""
    return torch.log(x.double()).float()


def uniform(keys: torch.Tensor, shape: Sequence[int],
            dtype: torch.dtype = torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` on ``[minval, maxval)`` under each key of
    ``keys [..., 2]``: ``[..., *shape]`` in ``dtype`` (float32 from 23
    random mantissa bits, bfloat16 from 7)."""
    _check_dtype(dtype)
    if dtype == torch.float32:
        bits = random_bits(keys, 32, shape)
        words = (bits >> 9) | 0x3F800000
        floats = to_int32(words).view(torch.float32) - 1.0
    else:
        bits = random_bits(keys, 8, shape)
        words = ((bits >> 1) | 0x3F80).to(torch.int16)
        floats = _rounded(words.view(torch.bfloat16).float() - 1.0, dtype)
    lo = _rounded(torch.tensor(minval, dtype=torch.float32), dtype)
    hi = _rounded(torch.tensor(maxval, dtype=torch.float32), dtype)
    span = _rounded(hi - lo, dtype)
    if dtype == torch.float32:
        # XLA fuses ``floats * span + lo`` into one multiply-add: the
        # product is exact in float64, so one rounding gives its bits
        out = (floats.double() * span.double() + lo.double()).float()
    else:
        out = _rounded(_rounded(floats * span, dtype) + lo, dtype)
    return torch.maximum(lo, out).to(dtype)


def gumbel(keys: torch.Tensor, shape: Sequence[int],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"): ``-log(-log(u))`` of a uniform on
    ``[tiny, 1)``, each op rounded to ``dtype``."""
    u = uniform(keys, shape, dtype, TINY, 1.0).float()
    inner = _rounded(_log(u), dtype)
    return (-_rounded(_log(-inner), dtype)).to(dtype)


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: ``keys [*K, 2]`` and
    ``logits [*K, *E]`` draw one gumbel per element of ``E`` under each
    key (so one key over ``[B, V]`` counts across rows, as a single JAX
    call does, and a ``[B, 2]`` batch of keys counts within each row, as
    its ``vmap`` does); returns the int32 argmax of ``gumbel + logits``,
    the first index on ties."""
    batch = keys.dim() - 1
    if tuple(logits.shape[:batch]) != tuple(keys.shape[:-1]):
        raise ValueError(
            f"keys {tuple(keys.shape)} do not lead logits "
            f"{tuple(logits.shape)}"
        )
    g = gumbel(keys, logits.shape[batch:], logits.dtype).float()
    scores = _rounded(g + logits.float(), logits.dtype)
    return scores.argmax(dim=-1).to(torch.int32)


def scale_logits(logits: torch.Tensor, temps: torch.Tensor) -> torch.Tensor:
    """``logits / t`` with ``t`` rounded to the logits' dtype first, as the
    JAX package's sampler divides (``temps [B]`` over rows, or a 0-dim
    tensor for every row); the quotient is rounded once."""
    t = _rounded(temps.float(), logits.dtype)
    if t.dim():
        t = t[:, None]
    return _rounded(logits.float() / t, logits.dtype).to(logits.dtype)
