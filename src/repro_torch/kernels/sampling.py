"""The serving steps' sampling tail: CUDA wrapper, launch count, plain
version.

``sample_rows(logits [S, V], temps [S], greedy [S], keys [S, 2])`` returns
``(next_tok [S] int32, new_keys [S, 2] int32)``, exactly the JAX package's
``_sample_rows`` (``repro/runtime/steps.py:293-305``): each row's key is
split in 2; a greedy row takes ``argmax(logits)``, a sampled row
``argmax(logits / max(t, 1e-4) + gumbel(sample key))`` (JAX's categorical,
first index on ties); the split's second half is the row's new key.
``categorical_rows(key [2], logits [B, V], temperature)`` is the per-burst
engine's sampled step (``repro/runtime/steps.py:135-146``): one key over
the whole ``[B, V]``, so the counters run across rows, no split.

It replaces no Pallas kernel: the JAX package's sampling tail is XLA-fused
code. Written as plain PyTorch integer ops, threefry costs on the order of
150 elementwise launches over ``[S, V]`` a step; the kernel
(``csrc/sample_rows.cu``) is one launch. Each thread hashes the 64-bit
counter of its element, turns the bits into a gumbel in the logits' type
(float32: 23 random bits; bfloat16: 8, each op rounded to bfloat16 as XLA's
CPU lowering rounds it, ``repro_torch.prng``'s docstring), and a CTA folds
its best (score, index) into the row's 64-bit word with one ``atomicMax``;
the row's last CTA writes the token and zeroes its workspace word, so the
kernel needs no memset between launches (and none inside a CUDA graph). The
logs are float32 rounded from float64 on both sides, so the kernel's
gumbels are the plain version's bits.

The wrappers run the plain version (``repro_torch.prng``) only for CPU
tensors. For CUDA tensors they launch the kernel or raise; there is no
fallback.
"""

from __future__ import annotations

import threading

import torch

from repro_torch import prng

from . import build
from repro_torch import capture_analysis
from repro_torch.capture_analysis import counted

# rows the workspace holds (one 64-bit best word and one ticket per row);
# allocated once per device, so a captured graph's pointers stay valid
WORKSPACE_ROWS = 4096
_workspaces: dict = {}
_ws_lock = threading.Lock()


def _workspace(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The device's zeroed ``(best [R] int64, ticket [R] int32)``: created
    on the first call outside a capture, and kept for the process."""
    with _ws_lock:
        ws = _workspaces.get(device)
        if ws is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "sample_rows: first call inside a CUDA graph capture; "
                    "run it once eagerly first"
                )
            ws = _workspaces[device] = (
                torch.zeros(WORKSPACE_ROWS, dtype=torch.int64, device=device),
                torch.zeros(WORKSPACE_ROWS, dtype=torch.int32, device=device),
            )
        return ws


def _check(name: str, logits: torch.Tensor, ints: dict) -> None:
    dev = logits.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    if logits.dtype not in build.DTYPE_CODES:
        raise ValueError(
            f"{name}: logits must be one of {tuple(build.DTYPE_CODES)}, got "
            f"{logits.dtype}"
        )
    if logits.dim() != 2 or logits.stride(-1) != 1 or logits.shape[-1] == 0:
        raise ValueError(
            f"{name}: logits must be [S, V] with a unit stride along V, got "
            f"{tuple(logits.shape)} strides {logits.stride()}"
        )
    rows = logits.shape[0]
    if not 0 < rows <= WORKSPACE_ROWS:
        raise ValueError(f"{name}: {rows} rows, the kernel takes 1-"
                         f"{WORKSPACE_ROWS}")
    for label, (t, shape, dtype) in ints.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or (
            not t.is_contiguous()
        ):
            raise ValueError(
                f"{name}: {label} must be contiguous {dtype} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


def _launch(name, logits, temps, greedy, keys, new_keys, split: bool,
            temperature: float, scores=None) -> torch.Tensor:
    rows, vocab = logits.shape
    tok = torch.empty(rows, dtype=torch.int32, device=logits.device)
    best, ticket = _workspace(logits.device)
    rc = build.load().sample_rows(
        logits.data_ptr(), logits.stride(0), rows, vocab,
        None if temps is None else temps.data_ptr(),
        None if greedy is None else greedy.data_ptr(),
        keys.data_ptr(), None if new_keys is None else new_keys.data_ptr(),
        tok.data_ptr(), best.data_ptr(), ticket.data_ptr(),
        None if scores is None else scores.data_ptr(),
        build.DTYPE_CODES[logits.dtype], int(split), float(temperature),
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    build.raise_on_error(name, rc)
    sample_rows.launches += 1
    return tok


@counted(capture_analysis.sample_extent)
def sample_rows(
    logits: torch.Tensor,  # [S, V] float32 or bfloat16
    temps: torch.Tensor,  # [S] float32
    greedy: torch.Tensor,  # [S] bool
    keys: torch.Tensor,  # [S, 2] int32 (uint32 bits)
    *,
    scores: torch.Tensor | None = None,  # [S, V] float32, written
) -> tuple[torch.Tensor, torch.Tensor]:
    """The sampling-as-data tail -> ``(next_tok [S] int32, new_keys [S, 2]
    int32)``. ``scores``, when given, receives every element's score as it
    was ranked (``sample_scores_plain``'s), to hold the draws bit for bit."""
    if logits.device.type == "cpu":
        if scores is not None:
            scores.copy_(sample_scores_plain(logits, temps, greedy, keys))
        return sample_rows_plain(logits, temps, greedy, keys)
    name = "sample_rows"
    s = logits.shape[0] if logits.dim() == 2 else -1
    ints = {
        "temps": (temps, (s,), torch.float32),
        "greedy": (greedy, (s,), torch.bool),
        "keys": (keys, (s, 2), torch.int32),
    }
    if scores is not None:
        ints["scores"] = (scores, tuple(logits.shape), torch.float32)
    _check(name, logits, ints)
    new_keys = torch.empty_like(keys)
    tok = _launch(name, logits, temps, greedy, keys, new_keys, True, 1.0,
                  scores)
    return tok, new_keys


sample_rows.launches = 0  # kernel launches (CUDA path only)


@counted(capture_analysis.categorical_extent)
def categorical_rows(key: torch.Tensor, logits: torch.Tensor,
                     temperature: float) -> torch.Tensor:
    """``jax.random.categorical(key, logits / temperature)`` over ``[B,
    V]`` with one ``key [2]`` -> ``[B]`` int32 (the same kernel, counted in
    ``sample_rows.launches``)."""
    if logits.device.type == "cpu":
        return categorical_rows_plain(key, logits, temperature)
    name = "categorical_rows"
    _check(name, logits, {"key": (key, (2,), torch.int32)})
    return _launch(name, logits, None, None, key, None, False, temperature)


def sample_rows_plain(logits, temps, greedy, keys):
    """Plain PyTorch version of ``sample_rows`` (``repro_torch.prng``):
    the categorical draw runs on the sampled rows only (a greedy row's
    draw is discarded either way)."""
    halves = prng.split(keys, 2)
    tok = logits.argmax(dim=-1).to(torch.int32)
    drawn = torch.nonzero(~greedy).flatten()
    if len(drawn):
        scaled = prng.scale_logits(logits[drawn],
                                   temps[drawn].clamp_min(1e-4))
        tok[drawn] = prng.categorical(halves[drawn, 0], scaled)
    return tok, halves[:, 1]


def sample_scores_plain(logits, temps, greedy, keys):
    """The scores ``sample_rows`` ranks, ``[S, V]`` float32: a sampled
    row's ``gumbel + logits / t`` in the logits' dtype, a greedy row's
    logits."""
    sample_keys = prng.split(keys, 2)[:, 0]
    scaled = prng.scale_logits(logits, temps.clamp_min(1e-4)).float()
    g = prng.gumbel(sample_keys, logits.shape[1:], logits.dtype).float()
    drawn = (g + scaled).to(logits.dtype).float()
    return torch.where(greedy[:, None], logits.float(), drawn)


def categorical_rows_plain(key, logits, temperature):
    """Plain PyTorch version of ``categorical_rows``."""
    t = torch.tensor(float(temperature), device=logits.device)
    return prng.categorical(key, prng.scale_logits(logits, t))
