"""Step builders for the paged serving lanes (counterpart of ``repro.runtime.steps``).

A step is a plain function over tensors; ``runtime.serve.Engine`` binds it to
a dispatch key's static shapes. Each step ends with its *bundle*: the next
step's chained input and one packed int32 tensor of every host-bound output,
so the serving loop pays exactly one device-to-host transfer per step.

Sampling draws from a ``torch.Generator`` owned by the batcher (one per
stream, seeded from its ``seed``); its streams are not comparable with the
JAX package's threefry keys. Greedy rows are exact.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import ArchConfig


def _sample_rows(
    logits: torch.Tensor,
    temps: torch.Tensor,
    greedy: torch.Tensor,
    generator: torch.Generator,
) -> torch.Tensor:
    """Sampling as data (DESIGN.md §4): per-row greedy flag and temperature,
    so a mode flip never touches the cold path. Sampled rows use the
    Gumbel-max trick (argmax of logits/t plus Gumbel noise), a draw from the
    softmax at temperature t. Returns next tokens i32[B]."""
    g = logits.argmax(dim=-1).to(torch.int32)
    t = temps.clamp_min(1e-4)[:, None].to(logits.dtype)
    u = torch.rand(
        logits.shape, generator=generator, device=logits.device,
        dtype=logits.dtype,
    )
    s = (logits / t - torch.log(-torch.log(u))).argmax(dim=-1).to(torch.int32)
    return torch.where(greedy, g, s)


def _step_bundle(nxt: torch.Tensor, new_pos: torch.Tensor):
    """``tok_col [S,1]`` (the chained next-step input) and ``packed [S,2]``
    (``[next_tok | new_pos]``, the step's one d2h transfer)."""
    tok_col = nxt[:, None]
    return tok_col, torch.stack([nxt, new_pos], dim=1)


def make_paged_slot_decode_fn(
    cfg: ArchConfig, *, attn_impl: str = "kernel"
) -> Callable:
    """Paged continuous-batching decode step (DESIGN.md §9):

        step(params, cache, tok[S,1], pos[S], block_tables[S,PB], active[S],
             temps[S], greedy[S], generator)
          -> (next_tok[S], cache, new_pos[S], tok_col[S,1], packed[S,2])

    Inactive slots carry all-null block tables, so their writes land in the
    null page; their positions do not advance."""

    def paged_slot_step(
        params, cache, tok, pos, block_tables, active, temps, greedy, generator
    ):
        logits, cache = models.paged_decode_step(
            cfg, params, cache, tok, pos, block_tables, attn_impl=attn_impl
        )
        nxt = _sample_rows(logits, temps, greedy, generator)
        new_pos = pos + active.to(torch.int32)
        return (nxt, cache, new_pos, *_step_bundle(nxt, new_pos))

    return paged_slot_step


def make_paged_prefill_fn(
    cfg: ArchConfig, *, attn_impl: str = "kernel"
) -> Callable:
    """Chunked-prefill step through the paged KV cache (DESIGN.md §10):

        step(params, cache, tok[B,CB], start[B], block_tables[B,PB],
             length[B], temps[B], greedy[B], generator)
          -> (next_tok[B], cache)

    ``next_tok`` is sampled from each row's last real chunk token and primes
    generation when the chunk reaches the prompt end. Columns >= ``length``
    are bucket padding: their K/V writes land in the null page."""

    def paged_prefill_step(
        params, cache, tok, start, block_tables, length, temps, greedy,
        generator,
    ):
        logits, cache = models.paged_prefill_step(
            cfg, params, cache, tok, start, block_tables, length,
            attn_impl=attn_impl,
        )
        return _sample_rows(logits, temps, greedy, generator), cache

    return paged_prefill_step


def pull_host(dev: torch.Tensor, recorder=None) -> tuple[np.ndarray, int]:
    """The d2h pull boundary: copy one device tensor to the host (blocking
    until the device has produced it). Returns ``(host_array, elapsed_ns)``;
    with an enabled flight recorder a "d2h" span lands on the scheduler
    track."""
    t0 = time.perf_counter_ns()
    out = dev.cpu().numpy()
    dt = time.perf_counter_ns() - t0
    if recorder is not None and recorder.enabled:
        recorder.emit(
            "d2h", "scheduler", ph="X", ts_ns=t0, dur_ns=dt,
            args={"nbytes": int(out.nbytes), "shape": list(out.shape)},
        )
    return out, dt
