"""H100 roofline accounting and the work reckonings of the port's kernels:
the counterpart of ``repro.roofline``.

Hardware constants: the NVIDIA H100 SXM5 80 GB data sheet's dense peaks —
HBM3 3.35 TB/s, bf16 tensor cores 989 TFLOP/s, fp32 67 TFLOP/s. They are
data-sheet values, not measurements: a card set below its 700 W limit runs
slower under load, so a number printed beside them names the card and its
power limit (``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``). The collective term reads a device's collective
bytes at the data sheet's NVLink rate, 900 GB/s (``NVLINK_BYTES_PER_S``),
where the JAX package reads TPU ICI links. The bytes come from the capture
report (``capture_analysis``: each collective's result bytes where
``distributed.collectives`` issues it), the counterpart of
``collective_bytes_from_hlo``; on one device there are none. On logical
devices of one card a collective is a copy in device memory, so that term
is the yardstick of a plan across cards, not of one card's.

Each hand-written kernel (B1-B8 and ``sample_rows``) has one reckoning of
the work a call does, ``Work(flops, bytes, transcendentals, int_ops)``, from
the shapes and counts the caller passes: ``chip_smoke.py`` passes what its
timed inputs need (the bound column of ``PERF.md`` §6), and the capture
report (``capture_analysis``) the key's static extent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 900e9  # the data sheet's NVLink bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# The sampling kernel's int32 operations per element of a sampled row —
# threefry-2x32 (2 + 5 x 12 round + 5 x 2 injection adds, a rotate being one
# funnel shift), the xor of its words and the float's shift and or — and
# per element of any row (the score's order-preserving packing and the
# running max); the card's int32 lanes: 132 SMs of 64.
SAMPLE_OPS_PER_DRAW = 75
SAMPLE_OPS_PER_ELEMENT = 4
INT32_LANES = 132 * 64


class Work(NamedTuple):
    """One call's work: products' flops (2 per multiply-add), bytes moved
    (each input read and each output written once), transcendental
    elements, and int32 operations (the sampling kernel's only work)."""

    flops: float
    bytes: float
    transcendentals: float = 0.0
    int_ops: float = 0.0


def bound_ms(work: Work, dtype: torch.dtype = torch.bfloat16,
             clock_hz: float | None = None) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes at the
    HBM rate and the operations at their peak (flops at ``dtype``'s, int32
    operations at ``INT32_LANES`` x ``clock_hz``), in ms, and which one
    bounds it ("bytes" or "operations")."""
    t_b = work.bytes / HBM_BYTES_PER_S
    if work.int_ops:
        if clock_hz is None:
            raise ValueError("int32 work needs the SM clock (clock_hz)")
        t_o = work.int_ops / (INT32_LANES * clock_hz)
    else:
        t_o = work.flops / PEAK_FLOPS[dtype]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# ------------------------------------------------------- kernel reckonings
def paged_attention_work(*, dh: int, pairs: int, kv_tokens: int,
                         kv_row_bytes: int, io_bytes: int,
                         softcap: bool = False) -> Work:
    """B1-B4 (paged decode and chunk attention, model-dtype or int8 pages):
    ``pairs`` query-key scores (QK^T and PV, 4 flops a pair per head_dim
    element), each visible K and V row read once (``kv_row_bytes``: KH x dh
    elements, plus the f32 scale on int8 pages), plus ``io_bytes`` (q, the
    output, the block table and positions); one exp a score, and a tanh
    with a softcap."""
    return Work(
        flops=4 * dh * pairs,
        bytes=2 * kv_tokens * kv_row_bytes + io_bytes,
        transcendentals=pairs * (2 if softcap else 1),
    )


def dense_decode_work(*, rows: int, heads: int, kv_heads: int, dh: int,
                      seen: int, elt: int, softcap: bool = False) -> Work:
    """B5: one query token a row over ``seen`` positions of a dense cache;
    K and V read once, q read and the output written, the int32 position."""
    pairs = rows * heads * seen
    return Work(
        flops=4 * dh * pairs,
        bytes=(2 * rows * seen * kv_heads * dh * elt
               + 2 * rows * heads * dh * elt + 4),
        transcendentals=pairs * (2 if softcap else 1),
    )


def flash_work(*, batch: int, seq: int, heads: int, dh: int, elt: int,
               pairs: int, kv_heads: int | None = None,
               softcap: bool = False) -> Work:
    """B6/B7: full-sequence attention; q, k, v read and the output written
    once, ``pairs`` scores the mode keeps (causal, window) per batch row and
    head."""
    kh = heads if kv_heads is None else kv_heads
    return Work(
        flops=4 * dh * pairs,
        bytes=(2 * heads + 2 * kh) * batch * seq * dh * elt,
        transcendentals=pairs * (2 if softcap else 1),
    )


def ssd_chunk_work(*, batch: int, seq: int, heads: int, head_dim: int,
                   state: int, chunk: int, elt: int) -> Work:
    """B8: x and y (``elt``), B and C as their one group, f32 dt and A, the
    f32 final state; flops of the causal half of the two L x L products
    per chunk, the inter-chunk term and the state update. One exp per
    decay element (the segment sums' L x L and the per-row decays)."""
    p, n = head_dim, state
    nbytes = (2 * batch * seq * heads * p * elt + 2 * batch * seq * n * elt
              + batch * seq * heads * 4 + heads * 4
              + batch * heads * p * n * 4)
    ops = trans = 0
    for c0 in range(0, seq, chunk):
        r = min(chunk, seq - c0)
        ops += 2 * (r * (r + 1) // 2) * (n + p) + 4 * r * p * n
        trans += r * (r + 1) // 2 + r
    return Work(flops=ops * batch * heads, bytes=nbytes,
                transcendentals=trans * batch * heads)


def sample_rows_work(*, rows: int, vocab: int, elt: int,
                     drawn_rows: int) -> Work:
    """``sample_rows``: the logits read once, the per-row temperature,
    greedy flag and key read, the token and new key written; int32
    operations for the rows that draw and for every row's ranking. The
    Gumbel draw's two logs per element of every row are its
    transcendentals (the JAX package draws for every row)."""
    return Work(
        flops=0.0,
        bytes=rows * vocab * elt + rows * (4 + 1 + 8) + rows * (4 + 8),
        transcendentals=2 * rows * vocab,
        int_ops=(drawn_rows * vocab * SAMPLE_OPS_PER_DRAW
                 + rows * vocab * SAMPLE_OPS_PER_ELEMENT),
    )


def roofline_terms(rec: dict, *, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The reference's three roofline terms (seconds) and usefulness ratio
    at the H100 constants, flops at ``dtype``'s peak:
    ``roofline_fraction`` = (the floor: the larger of ``model_flops`` at
    peak and ``min_bytes_global`` — weights and cache moved once — at the
    HBM rate) / (the largest term). ``t_collective_s`` is a device's
    collective bytes at the NVLink rate (0 on one device)."""
    peak = PEAK_FLOPS[dtype]
    f = rec["flops_per_device"]
    b = rec["bytes_per_device"]
    c = sum(rec["collective_bytes_per_device"].values())
    chips = rec["chips"]
    t_compute = f / peak
    t_memory = b / HBM_BYTES_PER_S
    t_coll = c / NVLINK_BYTES_PER_S
    dominant = max(
        [("compute", t_compute), ("memory", t_memory), ("collective", t_coll)],
        key=lambda kv: kv[1],
    )[0]
    total_flops = f * chips
    useful = rec["model_flops"] / total_flops if total_flops else 0.0
    bound = max(t_compute, t_memory, t_coll)
    ideal_compute = rec["model_flops"] / chips / peak
    ideal_memory = rec.get("min_bytes_global", 0.0) / chips / HBM_BYTES_PER_S
    floor = max(ideal_compute, ideal_memory)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "useful_flops_ratio": useful,
        "ideal_compute_s": ideal_compute,
        "ideal_memory_s": ideal_memory,
        "roofline_fraction": (floor / bound) if bound else 0.0,
    }
