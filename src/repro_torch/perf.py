"""Perf-iteration knobs, threaded via a context (the port's copy of
``repro.perf``: the same fields, defaults and functions).

The paper-faithful baseline is ``PerfOpts()``; each knob is one field. Model
code reads the ambient opts, so the knobs stay out of the model signatures:

* ``impl`` — what ``impl="auto"`` in ``attention``/``prefill_attention``
  resolves to (``"naive"`` or ``"chunked"``; the port's own default argument
  stays ``"kernel"``);
* ``attn_block`` — the key block of ``"chunked"``;
* ``score_dtype`` / ``probs_dtype`` — scores and probabilities of the
  ``"naive"`` and ``"chunked"`` attention below f32 (bf16). The kernels
  keep both in f32, so with ``impl="kernel"`` or ``attn_impl="kernel"``
  either one raises ``ValueError`` (``check_kernel_opts``) rather than being
  ignored;
* ``norm_bf16`` — ``rms_norm``/``ln_nonparam`` keep the normalised product
  in the residual dtype (only the per-token reduction in f32).

* ``remat_policy`` — what ``forward``'s remat keeps for the backward pass
  (``"full"`` recomputes a period of blocks, ``"dots"`` keeps the matrix
  products' outputs).

* ``moe_hints`` and ``moe_weight_gather`` — in the JAX package, sharding
  constraints on the MoE tail for GSPMD: the dispatch buffer and expert
  hidden state at "batch over data, experts over model", and the expert
  weights gathered over ``data`` at their use. Both change nothing
  without a mesh. On a mesh the port lays the tail out by hand in exactly
  those layouts (each data row runs its own tokens, a shard holds its
  experts wherever ``model`` divides E, and ``fsdp.gather_params`` gathers
  every weight over ``data`` at use), so each flag selects the layout the
  port already has: ``models.moe.check_mesh_opts`` reads them there and
  raises if the layout were ever another.

* ``seq_shard_fallback`` — on a mesh whose ``model`` axis does not divide
  the heads, full-sequence attention (the training loss and ``prefill``)
  splits the query sequence over ``model`` instead of running whole on
  every shard (``distributed.sharding.attn_q_split``, read by
  ``models.tensor_parallel``). Decode and the serving lanes never read it,
  as in the JAX package. It changes no value beyond the order of sums.

The opts are semi-static: a serving target captures ``current()`` when it
is built (``bake``) and runs under those opts on every call, as a traced
JAX step bakes them in, so a CUDA graph replays what it captured whatever
the ambient context is later.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from dataclasses import dataclass, replace
from typing import Callable

@dataclass(frozen=True)
class PerfOpts:
    # attention
    impl: str = "naive"  # naive (paper-faithful S^2) | chunked (online softmax)
    attn_block: int = 1024  # chunked KV block
    seq_shard_fallback: bool = False  # shard q-seq over model when heads don't divide
    probs_dtype: str | None = None  # cast softmax probs for the PV matmul
    score_dtype: str | None = None  # keep attention scores sub-f32 (bf16)
    # norms: keep the normalized product in the residual dtype (f32 only
    # for the per-token reduction)
    norm_bf16: bool = False
    # remat
    remat_policy: str = "full"  # full | dots (checkpoint_dots)
    # moe
    moe_hints: bool = False  # explicit EP sharding constraints in dispatch
    moe_weight_gather: bool = False  # force FSDP weight all-gather at use site


_OPTS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_perf_opts", default=PerfOpts()
)


def current() -> PerfOpts:
    return _OPTS.get()


@contextlib.contextmanager
def use_perf_opts(opts: PerfOpts):
    tok = _OPTS.set(opts)
    try:
        yield
    finally:
        _OPTS.reset(tok)


def from_flags(**kw) -> PerfOpts:
    return replace(PerfOpts(), **{k: v for k, v in kw.items() if v is not None})


def check_kernel_opts(where: str, opts: PerfOpts | None = None) -> None:
    """Raise ``ValueError`` where ``where`` runs the attention kernels under
    a sub-f32 ``score_dtype`` or ``probs_dtype``: the kernels keep scores and
    probabilities in f32, so the knob would be silently ignored."""
    po = current() if opts is None else opts
    if po.score_dtype is not None or po.probs_dtype is not None:
        raise ValueError(
            f"{where}: the attention kernels keep scores and probabilities in "
            f"float32; score_dtype={po.score_dtype!r} / probs_dtype="
            f"{po.probs_dtype!r} needs impl 'naive' or 'chunked' (attn_impl "
            f"'plain' has no such knob)"
        )


def bake(fn: Callable) -> Callable:
    """``fn`` bound to the opts current now: every call runs under them."""
    opts = current()

    @functools.wraps(fn)
    def baked(*args, **kwargs):
        with use_perf_opts(opts):
            return fn(*args, **kwargs)

    return baked
