"""Semi-static conditions — the paper's construct on PyTorch + CUDA
(counterpart of ``repro.core.semistatic``).

The paper (Bilokon, Lucuta & Shermer 2023) decouples *branch-changing*
(expensive, cold path: patch a relative ``jmp`` in the text segment) from
*branch-taking* (cheap, hot path: a direct call through the patched
trampoline).

On the card (DESIGN.md §2):

* branch targets      -> CUDA graphs captured once (``core.graph_target``)
* patched ``jmp``     -> rebinding one slot (``self._current``) to a graph
* ``branch(...)``     -> a replay of the current graph: no tracing, no
                         per-kernel launch from Python, no on-device
                         conditional
* ``set_direction``   -> cold-path slot rebind (+ optional ``warm``: replay
                         the newly selected graph on the example inputs and
                         synchronise — the analogue of the paper's "dummy
                         orders")
* guard rails         -> every branch's outputs share one ``(shape, dtype)``
                         signature (the paper's ±2GiB displacement error)
                         and one instance per entry-point name

On the CPU (``device="cpu"``) the branches stay plain callables: ``compile``
runs each once on the example inputs to record and compare its outputs.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .graph_target import GraphTarget


class BranchChangerError(RuntimeError):
    """Raised for misuse that would lead to undefined behaviour (paper §5.2)."""


# Registry of live entry points, mirroring the paper's "one instance per
# template specialisation" rule: two BranchChangers sharing a name would
# silently fight over the same entry point.
_ENTRY_POINTS: dict[str, "BranchChanger"] = {}
_REGISTRY_LOCK = threading.Lock()


def _out_signature(out: Any) -> Any:
    return pytree.tree_map(
        lambda x: (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
        else x,
        out,
    )


@dataclass
class SwitchStats:
    """Instrumentation for the paper's Fig. 11/13 analogues."""

    switches: int = 0
    compiles: int = 0
    warms: int = 0
    compile_seconds: float = 0.0
    last_switch_seconds: float = 0.0
    history: list = field(default_factory=list)


class BranchChanger:
    """N-ary semi-static condition over captured branch targets.

    Usage (mirrors the paper's API)::

        bc = BranchChanger(if_fn, else_fn, name="order-path")
        bc.compile(*example_args)           # capture every branch
        bc.set_direction(True, warm=True)   # cold path
        out = bc.branch(*args)              # hot path: one replay

    ``set_direction(condition)`` with a bool selects ``if_fn`` for True
    (paper semantics); integers select the i-th branch (the switch
    generalisation). On the card every branch is captured over one shared
    set of static inputs (``static_inputs``), so a caller that writes its
    inputs there in place pays no copy on a call, and the branches' graphs
    share one memory pool: a branch's outputs are valid until the next
    call."""

    def __init__(
        self,
        *branches: Callable,
        name: str | None = None,
        device: torch.device | str = "cuda",
    ):
        if len(branches) < 2:
            raise BranchChangerError(
                "BranchChanger requires at least two branch targets (if/else)."
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BranchChanger captures its branches on the GPU by default "
                "and no CUDA device is available; pass device='cpu' to run "
                "them as plain callables."
            )
        self._branches: tuple[Callable, ...] = branches
        self._name = name or f"branch@{id(self):x}"
        self._compiled: list[Callable] | None = None
        self._out_avals: Any = None
        self._example_args: tuple | None = None
        self.static_inputs: tuple | None = None
        self._direction: int = 0
        # The "entry point": a single mutable slot. Hot path reads only this.
        self._current: Callable = branches[0]
        self._lock = threading.Lock()
        self.stats = SwitchStats()
        with _REGISTRY_LOCK:
            if self._name in _ENTRY_POINTS:
                raise BranchChangerError(
                    f"More than one BranchChanger instance for entry point "
                    f"{self._name!r}. Multiple instances sharing the same entry "
                    f"point is dangerous and results in undefined behaviour "
                    f"(paper §5.2); pass a unique name=..."
                )
            _ENTRY_POINTS[self._name] = self

    # ------------------------------------------------------------ capture
    def compile(self, *example_args: torch.Tensor) -> "BranchChanger":
        """Build every branch target against the same example inputs.

        The analogue of the paper's requirement that all branch targets
        share one calling convention: every branch takes the same inputs
        and must produce outputs of the same ``(shape, dtype)``, else the
        trampoline is unsound. On the card each branch becomes a
        ``GraphTarget``; on the CPU each runs once."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            shared = tuple(t.detach().clone() for t in example_args)
            pool = torch.cuda.graph_pool_handle()
            targets = [
                GraphTarget(fn, example_args, pool=pool, static_inputs=shared,
                            name=f"{self._name}[{i}]").capture()
                for i, fn in enumerate(self._branches)
            ]
            sigs = [t.out_signature for t in targets]
            self.static_inputs = shared
        else:
            targets = list(self._branches)
            sigs = [_out_signature(fn(*example_args)) for fn in targets]
        for i, sig in enumerate(sigs):
            if sig != sigs[0]:
                raise BranchChangerError(
                    f"Branch target {i} of {self._name!r} produces outputs "
                    f"{sig} incompatible with branch 0 {sigs[0]}; all "
                    f"branches must share one calling convention (paper's "
                    f"displacement guard)."
                )
        self._compiled = targets
        self._out_avals = sigs[0]
        self._example_args = example_args
        self._current = targets[self._direction]
        self.stats.compiles += len(targets)
        self.stats.compile_seconds += time.perf_counter() - t0
        return self

    @property
    def is_compiled(self) -> bool:
        return self._compiled is not None

    @property
    def direction(self) -> int:
        return self._direction

    @property
    def name(self) -> str:
        return self._name

    # ----------------------------------------------------------- cold path
    def _index(self, condition: bool | int) -> int:
        if isinstance(condition, torch.Tensor):
            raise BranchChangerError(
                f"Direction of {self._name!r} must be a host value, got a "
                f"tensor (reading it would synchronise the device)."
            )
        if isinstance(condition, (bool, np.bool_)):
            idx = 0 if condition else 1
        else:
            idx = int(condition)
        if not 0 <= idx < len(self._branches):
            raise BranchChangerError(
                f"Direction {condition!r} out of range for "
                f"{len(self._branches)}-way branch {self._name!r}."
            )
        return idx

    def set_direction(
        self,
        condition: bool | int,
        *,
        warm: bool = False,
        warm_args: tuple | None = None,
    ) -> None:
        """Cold path: rebind the entry point; optionally warm the new target.

        The rebind itself is a single reference assignment — the Python-level
        analogue of the paper's 4-byte ``memcpy`` — and is atomic with respect
        to concurrent hot-path readers (single-writer safe without locks, the
        property the paper measures in its multi-threaded benchmark).
        """
        t0 = time.perf_counter()
        idx = self._index(condition)
        target = (
            self._compiled[idx] if self._compiled is not None
            else self._branches[idx]
        )
        self._direction = idx
        self._current = target  # <- the "jmp patch"
        if warm:
            self.warm(warm_args)
        self.stats.switches += 1
        self.stats.last_switch_seconds = time.perf_counter() - t0

    def set_direction_safe(self, condition: bool | int, **kw: Any) -> None:
        """Locked variant (the paper's ``-DSAFE_MODE``); strictly slower."""
        with self._lock:
            self.set_direction(condition, **kw)

    def warm(self, warm_args: tuple | None = None) -> None:
        """Run the currently selected target and wait for it.

        The analogue of the paper's BTB warming with dummy orders: the first
        call after a direction change pays one-time costs (the graph's
        upload, the host dispatch path); warming pays them in the cold path
        so the hot path never observes them. Without ``warm_args`` it runs
        on the example inputs (on the card: the static inputs as they
        stand)."""
        args = warm_args
        if args is None:
            if self._example_args is None:
                raise BranchChangerError(
                    f"warm() on {self._name!r} needs warm_args before "
                    f"compile()."
                )
            args = self.static_inputs or self._example_args
        self._current(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.warms += 1

    # ------------------------------------------------------------ hot path
    def branch(self, *args: Any) -> Any:
        """Hot path: direct call of the pre-selected target. No conditionals."""
        return self._current(*args)

    # Make the instance itself callable so it can drop into call sites.
    __call__ = branch

    # -------------------------------------------------------------- admin
    def close(self) -> None:
        with _REGISTRY_LOCK:
            _ENTRY_POINTS.pop(self._name, None)

    def __enter__(self) -> "BranchChanger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def reset_entry_points() -> None:
    """Test hook: forget all live entry points."""
    with _REGISTRY_LOCK:
        _ENTRY_POINTS.clear()


def live_entry_points() -> tuple[str, ...]:
    with _REGISTRY_LOCK:
        return tuple(_ENTRY_POINTS)
