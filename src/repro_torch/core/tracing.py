"""Host-decided semi-static conditions (counterpart of
``repro.core.tracing``).

A data-dependent branch on the device (``torch.where`` over both results,
or ``if bool(t)``, which synchronises the host with the device and cannot
be captured in a CUDA graph) is the paper's "conditional branch".
``semi_static`` decides on the host with a host value and runs only the
selected branch — so inside a captured step only that branch's kernels are
recorded, the paper's "compile-time template polymorphism" whose direction
can still change at runtime by capturing again on the cold path.

Passing a tensor where a host value is required fails loudly, the
counterpart of the JAX package rejecting a tracer.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from .semistatic import BranchChangerError


def _require_host_value(x: Any, what: str) -> None:
    if isinstance(x, torch.Tensor):
        raise BranchChangerError(
            f"{what} must be a host (Python) value for a semi-static "
            f"condition; got a tensor. Reading a device tensor synchronises "
            f"the host and fails under graph capture: select on the device "
            f"(torch.where) for data-dependent branches, or hoist the "
            f"condition to the cold path and re-specialise."
        )


def semi_static(
    condition: bool, if_branch: Callable, else_branch: Callable, *args: Any
) -> Any:
    """Two-way semi-static condition: only the taken branch runs."""
    _require_host_value(condition, "semi_static condition")
    return if_branch(*args) if condition else else_branch(*args)


def semi_static_switch(index: int, branches: Sequence[Callable], *args: Any) -> Any:
    """N-way semi-static condition (the paper's switch generalisation)."""
    _require_host_value(index, "semi_static_switch index")
    idx = int(index)
    if not 0 <= idx < len(branches):
        raise BranchChangerError(
            f"semi_static_switch index {idx} out of range [0, {len(branches)})."
        )
    return branches[idx](*args)
