"""Build, load and launch the port's CUDA kernels.

Each source in ``repro_torch/csrc`` is compiled at first use with ``nvcc``
into its own shared library with a plain C interface, loaded with
``ctypes``. The sources build as parallel ``nvcc`` processes, one per file
(the model-dtype paged kernels B1/B2, the int8 ones B3/B4, dense decode B5
and flash attention B6/B7, all over one shared header, and the SSD chunked
scan B8). Each library lands in ``build/repro_torch/`` at the root of the
checkout, named by a hash of its source, the shared header and the flags, so
an edit rebuilds and an unchanged tree reuses the last build. Nothing here
runs at import: a CPU-only install imports every module and never needs
``nvcc``.
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
from types import SimpleNamespace

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
HEADERS = ("paged_attention.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Instantiated specialisations (csrc/paged_attention.cuh: by_shape/launch).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 128)
PAGE_SIZES = (8, 16)

_ptr, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_i64 = ctypes.c_longlong  # element strides
# source -> {entry point: argtypes}
SOURCES = {
    "paged_attention.cu": {
        # q, k_pages, v_pages, block_tables, pos, out, batch, heads,
        # kv_heads, pages_per_row, dtype, head_dim, page_size, has_window,
        # window, has_softcap, softcap, sm_scale, stream
        "paged_decode_attention": [_ptr] * 6 + [_int] * 10 + [_float] * 2
        + [_ptr],
        # as decode, with the chunk length after batch
        "paged_prefill_attention": [_ptr] * 6 + [_int] * 11 + [_float] * 2
        + [_ptr],
    },
    "paged_attention_int8.cu": {
        # as paged_decode_attention, with k_scale, v_scale after v_pages
        "paged_decode_attention_int8": [_ptr] * 8 + [_int] * 10
        + [_float] * 2 + [_ptr],
        # as paged_prefill_attention, with k_scale, v_scale after v_pages
        "paged_prefill_attention_int8": [_ptr] * 8 + [_int] * 11
        + [_float] * 2 + [_ptr],
    },
    "decode_attention.cu": {
        # q, k, v, pos, out, batch, heads, kv_heads, seq_len, strides q
        # (b, h), k/v (b, s, h), out (b, h), dtype, head_dim, has_window,
        # window, has_softcap, softcap, sm_scale, stream
        "dense_decode_attention": [_ptr] * 5 + [_int] * 4 + [_i64] * 7
        + [_int] * 5 + [_float] * 2 + [_ptr],
    },
    "flash_attention.cu": {
        # q, k, v, out, batch, heads, kv_heads, sq, sk, strides (b, h, s)
        # of q, k, v, out, dtype, head_dim, causal, has_window, window,
        # has_softcap, softcap, sm_scale, stream
        "flash_attention": [_ptr] * 4 + [_int] * 5 + [_i64] * 12
        + [_int] * 6 + [_float] * 2 + [_ptr],
        # q, k, v, flags, out, batch, heads, kv_heads, sq, sk, 12 strides,
        # dtype, head_dim, sm_scale, stream
        "flash_attention_branchy": [_ptr] * 5 + [_int] * 5 + [_i64] * 12
        + [_int] * 2 + [_float] + [_ptr],
    },
    "ssd_chunk.cu": {
        # x, b, c, dt, a, y, state, batch, seqlen, heads, heads_per_group,
        # strides x (b, s, h), b and c (b, s, g), dt (b, s, h), dtype,
        # chunk, headdim, state_dim, stream; the (chunk, headdim, state)
        # instantiations are kernels/ssd_chunk.py:SSD_SHAPES
        "ssd_chunk": [_ptr] * 7 + [_int] * 4 + [_i64] * 12 + [_int] * 4
        + [_ptr],
    },
}

_lock = threading.Lock()
_lib: SimpleNamespace | None = None
# {"seconds", "libraries", "log"} of this process's load; "seconds" is the
# wall time of the parallel build (or of loading cached libraries)
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = Path(home or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str = "paged_attention.cu") -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*HEADERS, source):
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def _start_compile(source: str, path: Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp


def _finish_compile(proc, tmp: Path, path: Path) -> str:
    log = proc.communicate()[0]
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    path.with_suffix(".log").write_text(log)
    return log


def load() -> SimpleNamespace:
    """The kernels' entry points, every source built on first use — all
    missing libraries at once, one ``nvcc`` each — and loaded once per
    process (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            paths = {src: library_path(src) for src in SOURCES}
            running = {
                src: _start_compile(src, path)
                for src, path in paths.items() if not path.exists()
            }
            logs = {}
            for src, path in paths.items():
                if src in running:
                    logs[src] = _finish_compile(*running[src], path)
                elif path.with_suffix(".log").exists():
                    logs[src] = path.with_suffix(".log").read_text()
                else:
                    logs[src] = ""
            fns = {}
            for src, path in paths.items():
                lib = ctypes.CDLL(str(path))
                for name, argtypes in SOURCES[src].items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = _int
                    fns[name] = fn
            build_info.update(
                seconds=time.perf_counter() - t0,
                libraries=[str(p) for p in paths.values()],
                log="\n".join(logs.values()),
            )
            _lib = SimpleNamespace(**fns)
    return _lib


def check_operands(
    name: str, q, k_pages, v_pages, block_tables, positions, q_ndim: int,
    k_scale=None, v_scale=None,
) -> None:
    """Validate what the CUDA kernels take; raise on anything else.

    Without scales the pages share q's type (B1/B2); with ``k_scale`` /
    ``v_scale`` the pages are int8 and the scales contiguous float32
    ``[P, page_size]`` on the same device (B3/B4)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    quant = k_scale is not None or v_scale is not None
    scales = (k_scale, v_scale) if quant else ()
    for t in (k_pages, v_pages, block_tables, positions, *scales):
        if t is None:
            raise ValueError(f"{name}: int8 pages need both k_scale and v_scale")
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
    for t in (q, k_pages, v_pages, block_tables, positions, *scales):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    page_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in DTYPE_CODES or k_pages.dtype != page_dtype or (
        v_pages.dtype != page_dtype
    ):
        want = "int8 pages" if quant else "pages of q's type"
        raise ValueError(
            f"{name}: q must be one of {tuple(DTYPE_CODES)} with {want}, got "
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
    n_pages, ps, kh, dh = k_pages.shape
    for t in scales:
        if t.dtype != torch.float32 or tuple(t.shape) != (n_pages, ps):
            raise ValueError(
                f"{name}: scales must be float32 [{n_pages}, {ps}], got "
                f"{t.dtype} {tuple(t.shape)}"
            )
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


def check_strided_operands(
    name: str, q, k, v, q_ndim: int, ints: dict,
) -> None:
    """Validate what the dense kernels (B5-B7) take; raise on anything else.

    q is ``[B, H, dh]`` (``q_ndim`` 3) or ``[B, H, Sq, dh]`` (4) and k/v
    ``[B, KH, S, dh]``, all of one type in ``DTYPE_CODES``, read through
    their strides: only ``dh`` needs a unit stride, so a transposed view of
    ``[B, S, KH, dh]`` is taken as it is. ``ints`` maps each int32
    operand's name to ``(tensor, required shape)`` (``pos`` ``()``, ``flags`` ``(3,)``)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    for t in (k, v, *(t for t, _ in ints.values())):
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"{name}: q, k, v must share one of {tuple(DTYPE_CODES)}, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != q_ndim or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)}"
        )
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: head_dim must have unit stride")
    b, kh, s, dh = k.shape
    if q.shape[0] != b or q.shape[-1] != dh or q.shape[1] % kh != 0 or s == 0:
        raise ValueError(
            f"{name}: q{tuple(q.shape)} does not fit k/v{tuple(k.shape)}"
        )
    for label, (t, shape) in ints.items():
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: {label} must be int32 {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
    if dh not in HEAD_DIMS:
        raise ValueError(
            f"{name}: no kernel instantiated for head_dim={dh} "
            f"(instantiated: head_dim {HEAD_DIMS})"
        )


def raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
