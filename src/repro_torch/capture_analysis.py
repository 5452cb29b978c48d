"""Per-key capture report: the port's counterpart of ``repro.hlo_analysis``.

The JAX package cost-analyses each compiled executable's HLO text
(``analyze_compiled``). The port has no HLO: a branch target is an eager
step or a CUDA graph captured from one. So ``analyze_target`` runs the step
once, eagerly, on the key's static shapes (the engine's build inputs: zero
tokens, positions and block tables, so only the reserved null page and
position 0 are written) and counts what the PyTorch dispatcher sees:

* ``flops`` — 2·M·N·K for every product (``torch.utils.flop_counter.
  FlopCounterMode``: matmuls, batched matmuls and the products an einsum
  lowers to), as ``hlo_analysis._dot_flops`` counts each dot;
* ``transcendentals`` — the elements of every exp, tanh, log, rsqrt, sqrt
  and pow, as ``_comp_cost`` counts them in the optimised HLO: softmax and
  its log as the exp and log they compute, a sigmoid or SiLU as the one exp
  XLA expands a logistic into, and a square (``pow(x, 2)``) as the multiply
  XLA emits, so none;
* ``bytes`` — the inputs and outputs of every op a ``TorchDispatchMode``
  sees (views excepted). There is no fusion, so every intermediate counts:
  this is not comparable with XLA's fusion-boundary bytes.
* ``collectives`` — the result bytes of every collective a device issues,
  by op type (``all-reduce``, ``all-gather``, ``collective-permute``), as
  ``hlo_analysis`` counts each collective's result shape once: counted
  where ``distributed.collectives`` runs ``all_reduce``, ``pmax``,
  ``all_gather`` and ``ppermute`` (``compressed_psum`` through its
  ``pmax`` and ``all_gather``), per mesh coordinate, and reported for the
  coordinate that moves the most; empty on one device.
  ``collective_bytes_total`` is their sum, ``unknown_trip_whiles`` 0
  (Python loops run unrolled).

On a mesh of several logical devices the report is one device's, as the
JAX package's is the partitioned per-device program's. The mesh steps
(``models.tensor_parallel``) issue every op once per coordinate, on its
rows and heads (a product split over ``model`` at 1/mp of its width), so
what runs inside them (``spread``) counts 1/devices to a device; the
step's tail after the rows' logits are gathered (the sampling) runs on the
mesh's first device and counts whole there, which makes the first device
the busiest. The per-row table arithmetic inside a mesh step is spread as
well, an undercount of a few integer ops a row.

Each hand-written kernel's wrapper (``counted``) adds its reckoning
(``roofline``) at the shapes it was given — the key's static extent, e.g.
``pages_bucket × page_size`` keys per decode row — to ``kernel_flops``,
``kernel_bytes`` and the totals, and the ops inside it (its plain version on
the CPU, its launch on the card) are not also counted. So one key gives the
same report on the CPU and on the card. A failure is folded into an
``{"error": ...}`` report: analysis never breaks a build.

**A step that takes a gradient** (``analyze_step``: the mesh train step of
``runtime.steps.lower_train``, and the dry run's prefill and decode). It
runs as the step asks (no ``torch.no_grad()`` around it), and a failure
raises. Autograd runs the backward inside ``torch.autograd.grad``, which
the step calls inside its ``spread`` region, so the backward counts 1/
devices to a device as its forward does. It adds ``mem``, the JAX
package's ``memory_analysis()`` fields under the port's conventions (not
XLA's buffer assignment):

* ``argument_bytes`` / ``output_bytes`` — the bytes the busiest coordinate
  holds of the step's arguments and outputs, exactly: its pieces, its
  piece of each global tensor by the spec the lowering gives it (the batch
  split over the rows), and a tensor without one whole on the first
  coordinate (the metrics, the gathered logits);
* ``temp_bytes`` — the peak of live intermediate storage (every op's
  outputs that are not an argument's storage, until the storage is freed,
  as a dispatch-mode tracker sees them), a storage made inside a
  ``spread`` region counted 1/devices as its ops are: every coordinate
  there runs the same ops on equal pieces, and on ``meta`` devices each
  holds its own copy of a collective's result;
* ``code_bytes`` — 0 (no generated code).
"""

from __future__ import annotations

import contextlib
import functools
import math
import weakref
from collections import defaultdict
from typing import Any, Callable, Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import roofline

# Transcendental elements per output element, by op (packet names).
_TRANSCENDENTAL = {
    "exp": 1, "exp2": 1, "expm1": 1, "tanh": 1, "log": 1, "log1p": 1,
    "log2": 1, "rsqrt": 1, "sqrt": 1, "pow": 1, "sigmoid": 1, "silu": 1,
    "_softmax": 1, "_log_softmax": 2,
}


class _Counter(TorchDispatchMode):
    """Bytes and transcendentals of every op outside a kernel region."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0
        self.paused = 0
        self.ops: dict = defaultdict(lambda: [0, 0])  # name -> calls, bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.paused or getattr(func, "is_view", False):
            return out
        nbytes = 0
        for t in _tensors((args, kwargs, out)):
            nbytes += t.numel() * t.element_size()
        self.bytes += nbytes
        name = func._overloadpacket.__name__
        self.ops[name][0] += 1
        self.ops[name][1] += nbytes
        per = _TRANSCENDENTAL.get(name)
        if (name == "pow" and len(args) > 1
                and isinstance(args[1], (int, float)) and args[1] == 2):
            per = 0  # a square
        if per:
            self.transcendentals += per * sum(
                t.numel() for t in _tensors(out))
        return out


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


class _Analysis:
    def __init__(self) -> None:
        self.flop_mode = FlopCounterMode(display=False)
        self.counter = _Counter()
        self.kernel = roofline.Work(0.0, 0.0, 0.0, 0.0)
        self.excluded_flops = 0
        # coordinate -> op type -> result bytes
        self.collectives: dict = defaultdict(lambda: defaultdict(float))
        self.spread: list[tuple[int, tuple]] = []  # (devices, totals' delta)
        self.devices = 1  # the open ``spread`` region's devices

    def totals(self) -> tuple:
        """(flops, bytes, transcendentals, kernel flops, kernel bytes) so
        far, the kernels' reckonings included."""
        k = self.kernel
        return (self.flop_mode.get_total_flops() - self.excluded_flops
                + k.flops, self.counter.bytes + k.bytes,
                self.counter.transcendentals + k.transcendentals, k.flops,
                k.bytes)

    def per_device(self) -> tuple:
        """``totals`` of the busiest device: what ran inside a ``spread``
        region at 1/devices, the rest whole."""
        out = list(self.totals())
        for devices, delta in self.spread:
            out = [x - d + d / devices for x, d in zip(out, delta)]
        return tuple(out)


_ACTIVE: _Analysis | None = None


def counted(reckon: Callable[..., roofline.Work]) -> Callable:
    """Decorate a kernel wrapper: under an analysis, add ``reckon(*args,
    **kwargs)`` (the call's work at its shapes) and count none of the ops
    inside the call. Otherwise the wrapper runs as it is."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            a = _ACTIVE
            if a is None or a.counter.paused:
                return fn(*args, **kwargs)
            w = reckon(*args, **kwargs)
            a.kernel = roofline.Work(*(x + y for x, y in zip(a.kernel, w)))
            f0 = a.flop_mode.get_total_flops()
            a.counter.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                a.counter.paused -= 1
                a.excluded_flops += a.flop_mode.get_total_flops() - f0

        return wrapper

    return deco


def collective(op: str) -> Callable:
    """Decorate a collective over a mesh axis (``fn(xs, mesh, axis, ...)``
    -> coordinate -> shard): under an analysis, none of its ops count as
    compute, and each coordinate's result bytes count under ``op``; over an
    axis of one device it moves nothing and counts nothing."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(xs, mesh, axis, *args, **kwargs):
            a = _ACTIVE
            if a is None or a.counter.paused:
                return fn(xs, mesh, axis, *args, **kwargs)
            f0 = a.flop_mode.get_total_flops()
            a.counter.paused += 1
            try:
                out: Mapping = fn(xs, mesh, axis, *args, **kwargs)
            finally:
                a.counter.paused -= 1
                a.excluded_flops += a.flop_mode.get_total_flops() - f0
            if mesh.shape[axis] > 1:
                for c, t in out.items():
                    a.collectives[c][op] += t.numel() * t.element_size()
            return out

        return wrapper

    return deco


@contextlib.contextmanager
def spread(devices: int):
    """The ops inside run once on each of ``devices`` mesh coordinates
    (each on its piece): a device's report counts 1/devices of them."""
    a = _ACTIVE
    if a is None or a.counter.paused or devices == 1:
        yield
        return
    if a.devices != 1:
        raise RuntimeError("spread regions do not nest")
    before = a.totals()
    a.devices = devices
    try:
        yield
    finally:
        a.devices = 1
        a.spread.append((devices, tuple(
            y - x for x, y in zip(before, a.totals()))))


def _report(a: _Analysis) -> dict:
    flops, nbytes, trans, kflops, kbytes = a.per_device()
    busiest = max(a.collectives.values(), key=lambda ops: sum(
        ops.values()), default={})
    colls = {op: float(n) for op, n in sorted(busiest.items())}
    return {
        "flops": float(flops),
        "bytes": float(nbytes),
        "transcendentals": float(trans),
        "collectives": colls,
        "collective_bytes_total": float(sum(colls.values())),
        "unknown_trip_whiles": 0,
        "kernel_flops": float(kflops),
        "kernel_bytes": float(kbytes),
    }


def analyze_target(step: Callable, *args: Any) -> dict:
    """Run ``step(*args)`` once under the counters and return the report
    (module docstring); ``{"error": ...}`` if anything fails."""
    global _ACTIVE
    try:
        a = _Analysis()
        _ACTIVE = a
        try:
            with torch.no_grad(), a.flop_mode, a.counter:
                step(*args)
        finally:
            _ACTIVE = None
        return _report(a)
    except Exception as exc:  # noqa: BLE001 - report, never break a build
        return {"error": f"{type(exc).__name__}: {exc}"}


class _Live(TorchDispatchMode):
    """The live bytes of op outputs (storages that are no argument's, each
    once, until it is freed) and their peak, for one device: a storage made
    inside a ``spread`` region counts 1/devices, as its ops do."""

    def __init__(self, args: Any) -> None:
        super().__init__()
        self.live = self.peak = 0
        self._held: set = set()
        self._args = {t.untyped_storage()._cdata for t in _tensors(args)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in ins or key in self._args or key in self._held:
                continue
            share = st.nbytes() / (_ACTIVE.devices if _ACTIVE else 1)
            self._held.add(key)
            self.live += share
            weakref.finalize(st, self._free, key, share)
        self.peak = max(self.peak, self.live)
        return out

    def _free(self, key: int, share: float) -> None:
        self._held.discard(key)
        self.live -= share


def piece_bytes(tree: Any, mesh, specs: Any = None) -> dict:
    """The bytes each coordinate of ``mesh`` holds of ``tree``: a mapping
    from coordinate to pieces, and a ``ShardedCache``'s ``shards``, count
    at their coordinates; a tensor whose place in ``specs`` (a structure
    parallel to ``tree``) is a spec counts its piece at every coordinate
    (``()``: replicated); any other tensor counts whole at the first."""
    from repro_torch.distributed.sharding import local_shape

    out = {c: 0 for c in mesh.coords()}
    first = mesh.coords()[0]

    def at(node: Any, c: tuple) -> None:
        out[c] += sum(t.numel() * t.element_size() for t in _tensors(node))

    def walk(node: Any, spec: Any) -> None:
        if isinstance(node, torch.Tensor):
            if spec is None:
                at(node, first)
                return
            n = math.prod(local_shape(node.shape, spec, mesh))
            for c in out:
                out[c] += n * node.element_size()
        elif hasattr(node, "shards") and hasattr(node, "mesh"):
            for c, pieces in node.shards.items():
                at(pieces, c)
        elif isinstance(node, Mapping) and node and all(k in out
                                                        for k in node):
            for c, pieces in node.items():
                at(pieces, c)
        elif isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, spec.get(k) if isinstance(spec, Mapping) else None)
        elif isinstance(node, (list, tuple)):
            parallel = (isinstance(spec, (list, tuple))
                        and len(spec) == len(node))
            for i, v in enumerate(node):
                walk(v, spec[i] if parallel else None)

    walk(tree, specs)
    return out


def analyze_step(step: Callable, args: tuple, *, mesh,
                 arg_specs: Any = None, op_table: bool = False) -> dict:
    """Run ``step(*args)`` once, as it asks (a gradient may be taken), under
    the counters and the live-storage tracker -> the report of
    ``analyze_target`` with ``mem`` (module docstring), and with
    ``op_table`` the counted ops by name (``{name: {"calls", "bytes",
    "flops"}}``, every coordinate's, before ``spread``'s 1/devices). Raises
    what the step raises."""
    global _ACTIVE
    a = _Analysis()
    live = _Live(args)
    _ACTIVE = a
    try:
        with a.flop_mode, a.counter, live:
            out = step(*args)
    finally:
        _ACTIVE = None
    rep = _report(a)
    rep["mem"] = {
        "argument_bytes": max(piece_bytes(args, mesh, arg_specs).values()),
        "output_bytes": max(piece_bytes(out, mesh).values()),
        "temp_bytes": int(live.peak),
        "code_bytes": 0,
    }
    if op_table:
        flops = {str(getattr(op, "__name__", op)): n for op, n in
                 a.flop_mode.get_flop_counts().get("Global", {}).items()}
        rep["op_table"] = {
            name: {"calls": calls, "bytes": nbytes,
                   "flops": flops.get(name, 0)}
            for name, (calls, nbytes) in sorted(a.counter.ops.items())}
    return rep


# ------------------------------------------- the wrappers' static extents
# Each takes a kernel wrapper's arguments and returns its reckoning at the
# shapes given: every key column of a row's table is a visible K/V row.
def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _kv_row_bytes(k_pages: torch.Tensor, scaled: bool) -> int:
    _, _, kh, dh = k_pages.shape
    return kh * dh * k_pages.element_size() + (4 if scaled else 0)


def paged_decode_extent(q, k_pages, v_pages, *rest, softcap=None,
                        **_) -> roofline.Work:
    """B1/B3: ``q [B, H, dh]``, a ``[B, PB]`` table of ``ps``-row pages."""
    scaled = len(rest) == 4  # int8: k_scale, v_scale, tables, pos
    bt, pos = rest[-2], rest[-1]
    b, h, dh = q.shape
    kv_tokens = b * bt.shape[1] * k_pages.shape[1]
    return roofline.paged_attention_work(
        dh=dh, pairs=kv_tokens * h, kv_tokens=kv_tokens,
        kv_row_bytes=_kv_row_bytes(k_pages, scaled),
        io_bytes=2 * _nbytes(q) + _nbytes(bt, pos),
        softcap=softcap is not None,
    )


def paged_prefill_extent(q, k_pages, v_pages, *rest, softcap=None,
                         **_) -> roofline.Work:
    """B2/B4: ``q [B, C, H, dh]`` over a ``[B, PB]`` table."""
    scaled = len(rest) == 4
    bt, start = rest[-2], rest[-1]
    b, c, h, dh = q.shape
    kv_tokens = b * bt.shape[1] * k_pages.shape[1]
    return roofline.paged_attention_work(
        dh=dh, pairs=kv_tokens * c * h, kv_tokens=kv_tokens,
        kv_row_bytes=_kv_row_bytes(k_pages, scaled),
        io_bytes=2 * _nbytes(q) + _nbytes(bt, start),
        softcap=softcap is not None,
    )


def dense_decode_extent(q, k, v, pos, *, softcap=None, **_) -> roofline.Work:
    """B5: ``q [B, H, dh]`` over a ``[B, KH, L, dh]`` cache, every row."""
    b, h, dh = q.shape
    return roofline.dense_decode_work(
        rows=b, heads=h, kv_heads=k.shape[1], dh=dh, seen=k.shape[2],
        elt=q.element_size(), softcap=softcap is not None,
    )


def flash_extent(q, k, v, *rest, causal=True, softcap=None,
                 **_) -> roofline.Work:
    """B6/B7: ``q [B, H, S, dh]``, causal: half the square and its
    diagonal."""
    b, h, s, dh = q.shape
    sk = k.shape[2]
    pairs = b * h * (s * (s + 1) // 2 if causal and s == sk else s * sk)
    return roofline.flash_work(
        batch=b, seq=s, heads=h, dh=dh, elt=q.element_size(), pairs=pairs,
        kv_heads=k.shape[1], softcap=softcap is not None,
    )


def ssd_extent(x, b, c, dt, a, *, chunk: int = 256, **_) -> roofline.Work:
    """B8: ``x [B, L, H, P]``, ``b [B, L, G, N]``."""
    bsz, seq, heads, p = x.shape
    return roofline.ssd_chunk_work(
        batch=bsz, seq=seq, heads=heads, head_dim=p, state=b.shape[-1],
        chunk=chunk, elt=x.element_size(),
    )


def sample_extent(logits, *_, **__) -> roofline.Work:
    """``sample_rows``: every row draws at the static extent."""
    rows, vocab = logits.shape
    return roofline.sample_rows_work(rows=rows, vocab=vocab,
                                     elt=logits.element_size(),
                                     drawn_rows=rows)


def categorical_extent(key, logits, temperature) -> roofline.Work:
    """``categorical_rows`` (the same kernel): every row draws."""
    return sample_extent(logits)
