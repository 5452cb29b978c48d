"""Build, load and launch the port's CUDA kernels.

The sources in ``repro_torch/csrc`` are compiled at first use with ``nvcc``
into a shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/repro_torch/`` at the root of the checkout, named
by a hash of the sources and flags, so an edit rebuilds and an unchanged
tree reuses the last build. Nothing here runs at import: a CPU-only install
imports every module and never needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("paged_attention.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Instantiated specialisations (csrc/paged_attention.cu: by_shape/launch).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 128)
PAGE_SIZES = (8, 16)

_ptr, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k_pages, v_pages, block_tables, pos, out, batch, heads, kv_heads,
    # pages_per_row, dtype, head_dim, page_size, has_window, window,
    # has_softcap, softcap, sm_scale, stream
    "paged_decode_attention": [_ptr] * 6 + [_int] * 10 + [_float] * 2 + [_ptr],
    # as decode, with the chunk length after batch
    "paged_prefill_attention": [_ptr] * 6 + [_int] * 11 + [_float] * 2 + [_ptr],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}  # {"seconds", "library", "log"} of this process's load


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = Path(home or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libpaged_attention-{h.hexdigest()[:16]}.so"


def _compile(path: Path) -> str:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    path.with_suffix(".log").write_text(log)
    return log


def load() -> ctypes.CDLL:
    """The kernel library, built on first use (thread-safe, once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            path = library_path()
            log = _compile(path) if not path.exists() else (
                path.with_suffix(".log").read_text()
                if path.with_suffix(".log").exists() else ""
            )
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _int
            build_info.update(
                seconds=time.perf_counter() - t0, library=str(path), log=log
            )
            _lib = lib
    return _lib


def check_operands(
    name: str, q, k_pages, v_pages, block_tables, positions, q_ndim: int
) -> None:
    """Validate what the CUDA kernels take; raise on anything else."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    for t in (k_pages, v_pages, block_tables, positions):
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
    for t in (q, k_pages, v_pages, block_tables, positions):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype or (
        v_pages.dtype != q.dtype
    ):
        raise ValueError(
            f"{name}: q/pages must share one of {tuple(DTYPE_CODES)}, got "
            f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}"
        )
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError(f"{name}: block tables and positions must be int32")
    if q.dim() != q_ndim or k_pages.dim() != 4 or (
        k_pages.shape != v_pages.shape
    ):
        raise ValueError(
            f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k_pages.shape)} "
            f"v{tuple(v_pages.shape)}"
        )
    _, ps, kh, dh = k_pages.shape
    b, h = q.shape[0], q.shape[-2]
    if q.shape[-1] != dh or h % kh != 0:
        raise ValueError(
            f"{name}: q heads/head_dim {h}/{q.shape[-1]} do not fit pages "
            f"with {kh} kv heads of {dh}"
        )
    if block_tables.dim() != 2 or block_tables.shape[0] != b or (
        tuple(positions.shape) != (b,)
    ):
        raise ValueError(f"{name}: block tables/positions must be [B, PB]/[B]")
    if dh not in HEAD_DIMS or ps not in PAGE_SIZES:
        raise ValueError(
            f"{name}: no kernel instantiated for head_dim={dh}, "
            f"page_size={ps} (instantiated: head_dim {HEAD_DIMS}, "
            f"page_size {PAGE_SIZES})"
        )


def raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
