"""Step builders for the paged serving lanes, the speculative lanes, the
per-burst engine and full-sequence prefill (counterpart of
``repro.runtime.steps``).

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


def make_decode_fn(cfg: ArchConfig, *, attn_impl: str = "kernel") -> Callable:
    """Plain decode step over the dense cache:

        step(params, cache, inputs[B,1], pos) -> (logits[B,V], cache)"""

    def serve_step(params, cache, inputs, pos):
        return models.decode_step(
            cfg, params, cache, inputs, pos, attn_impl=attn_impl
        )

    return serve_step


def make_sampling_decode_fn(
    cfg: ArchConfig,
    *,
    mode: int,
    temperature: float = 1.0,
    attn_impl: str = "kernel",
) -> Callable:
    """Decode step with the sampling mode *baked into the target* — the
    per-burst engine's branch targets, one per ``("burst", bucket, mode)``
    key (DESIGN.md §2):

        step(params, cache, inputs[B,1], pos, generator) -> (tok[B], cache)

    ``pos`` is a 0-dim int32 device tensor (every row at one position).
    ``mode`` 0 = greedy (argmax), 1 = a sample at ``temperature`` drawn from
    ``generator`` (Gumbel-max, as ``_sample_rows``; the JAX package draws
    from threefry keys, so only greedy bursts compare token for token).
    Flipping mode means dispatching another target: cheap once built, but a
    build on first sight and a slot rebind per flip."""
    if mode not in (0, 1):
        raise ValueError(f"mode must be 0 (greedy) or 1 (sample), got {mode}")
    decode = make_decode_fn(cfg, attn_impl=attn_impl)

    def step(params, cache, inputs, pos, generator):
        logits, cache = decode(params, cache, inputs, pos)
        if mode == 0:
            return logits.argmax(dim=-1).to(torch.int32), cache
        u = torch.rand(
            logits.shape, generator=generator, device=logits.device,
            dtype=logits.dtype,
        )
        g = logits / temperature - torch.log(-torch.log(u))
        return g.argmax(dim=-1).to(torch.int32), cache

    return step


def make_prefill_fn(cfg: ArchConfig, *, impl: str = "kernel") -> Callable:
    """Full-prompt prefill: ``step(params, inputs[B,S]) -> (logits[B,V],
    cache [m,B,S,KH,dh] per slot, or a mamba slot's {conv, state})``;
    ``impl`` as ``models.prefill`` (B6 and B8 with ``"kernel"``)."""

    def prefill_step(params, inputs):
        return models.prefill(cfg, params, inputs, impl=impl)

    return prefill_step


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


def pack_verify_d2h(rows: torch.Tensor, nxt0: torch.Tensor) -> torch.Tensor:
    """``[S,K+1]`` verify rows + ``[S]`` row-0 samples -> one ``[S,K+2]``
    int32 tensor: the verify step's single d2h transfer."""
    return torch.cat([rows, nxt0[:, None]], dim=1)


def make_paged_verify_fn(
    cfg: ArchConfig, *, attn_impl: str = "kernel"
) -> Callable:
    """Verify lane through the paged KV cache (DESIGN.md §11):

        step(params, cache, tok[S,K+1], start[S], block_tables[S,PB],
             length[S], temps[S], greedy[S], generator)
          -> (rows[S,K+1], next0[S], cache, packed[S,K+2])

    ``tok`` is each slot's current token followed by its K draft
    candidates; all K+1 positions are scored in one target pass through the
    chunk path (columns >= ``length`` write only the null page).
    ``rows[s, i]`` is the greedy continuation after rows 0..i — acceptance
    and the correction token are host-side comparisons over it. ``next0``
    is the mode-respecting sample from row 0 (one generator draw, as a
    decode step), so a length-1 window is a decode step and sampling slots
    ride the same call. ``packed`` is ``pack_verify_d2h(rows, next0)``."""

    def verify_step(
        params, cache, tok, start, block_tables, length, temps, greedy,
        generator,
    ):
        logits, cache = models.paged_verify_step(
            cfg, params, cache, tok, start, block_tables, length,
            attn_impl=attn_impl,
        )
        rows = logits.argmax(dim=-1).to(torch.int32)
        nxt0 = _sample_rows(logits[:, 0], temps, greedy, generator)
        return rows, nxt0, cache, pack_verify_d2h(rows, nxt0)

    return verify_step


def make_draft_fn(draft_cfg: ArchConfig, *, k: int) -> Callable:
    """Draft lane (DESIGN.md §11): K greedy candidates per slot in one
    branch target, the ``("dr", slots, k_bucket, draft_kv_dtype)`` key:

        step(draft_params, draft_cache, tok[S,1], pos[S], active[S])
          -> (drafts[S,K], draft_cache, new_pos[S])

    ``draft_cfg``/``draft_params`` are the truncated-layer view
    (``models.draft_view``), ``draft_cache`` its dense per-slot cache. The K
    decode steps loop inside the target, so k is fixed when it is built;
    each step feeds the previous candidate back and writes the draft's KV
    at the advancing position (the scheduler later rewinds ``pos`` as data
    and the next round overwrites a rejected tail). Candidates are greedy,
    as the JAX package's scheduler forces them, so the draft draws nothing
    from the batcher's generator and sampled streams are untouched."""

    def draft_step(params, cache, tok, pos, active):
        drafts = []
        for _ in range(k):
            logits, cache = models.decode_step(draft_cfg, params, cache, tok, pos)
            nxt = logits.argmax(dim=-1).to(torch.int32)
            drafts.append(nxt)
            tok = nxt[:, None]
            pos = pos + active.to(torch.int32)
        return torch.stack(drafts, dim=1), cache, pos

    return draft_step


def make_slot_prefill_fn(cfg: ArchConfig) -> Callable:
    """Chunked prefill into the dense per-slot cache (DESIGN.md §10) — the
    draft's prompt mirror, the ``("drp", slots, chunk_bucket,
    draft_kv_dtype)`` key:

        step(params, cache, tok[S,CB], start[S], length[S], temps[S],
             greedy[S], generator)
          -> (next_tok[S], cache)

    Every slot carries its own chunk window (``length`` 0 = idle row,
    writes nothing). The batcher discards ``next_tok`` and hands this lane a
    generator of its own, so the mirror never moves the sampled streams."""

    def slot_prefill_step(
        params, cache, tok, start, length, temps, greedy, generator
    ):
        logits, cache = models.chunked_decode_step(
            cfg, params, cache, tok, start, length
        )
        return _sample_rows(logits, temps, greedy, generator), cache

    return slot_prefill_step


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
