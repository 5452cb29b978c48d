"""``KernelBranch``: the paper's construct at the kernel level (counterpart of
``repro.kernels.ops.KernelBranch``).

A table of mode-specialised flash-attention kernels (B6): ``set_mode`` is
the cold path — it selects (building on first sight) the specialisation for
(causal, window, softcap) — and ``__call__`` is the hot path, a direct call
of the selected kernel with no mode test anywhere. ``branchy=True`` makes the
same object the conditional baseline: one kernel (B7) for every mode, and
``set_mode`` writes the mode into an int32[3] flags tensor that every tile
reads and selects on. Holding the two side by side per mode is the paper's
specialised-vs-conditional comparison (``benchmarks/kernel_specialization.py``
in the JAX package).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from repro_torch.core.specialization import SpecTable

from .flash_attention import flash_attention, flash_attention_branchy


class KernelBranch:
    """Semi-static kernel dispatch: mode -> specialised kernel (or, with
    ``branchy``, mode -> flags of the one runtime-flag kernel)."""

    def __init__(self, name: str = "flash", *, branchy: bool = False):
        self._table = SpecTable(name)
        self.branchy = branchy
        self._flags: torch.Tensor | None = None
        self.set_mode()

    @property
    def mode(self) -> tuple:
        return self._mode

    def set_mode(
        self,
        *,
        causal: bool = True,
        window: Optional[int] = None,
        softcap: Optional[float] = None,
    ) -> None:
        """Cold path: rebind the hot call to this mode's specialisation (B6)
        or rewrite the flags (B7; the cap must be an integer, as in the
        Pallas kernel's flags)."""
        self._mode = (causal, window, softcap)
        if self.branchy:
            if softcap is not None and softcap != int(softcap):
                raise ValueError(
                    f"the runtime-flag kernel takes an integer softcap, got "
                    f"{softcap}"
                )
            self._flags = torch.tensor(
                [int(causal), int(window or 0), int(softcap or 0)],
                dtype=torch.int32,
            )
            self._fn = flash_attention_branchy
            return
        self._fn = self._table.get_or_build(
            self._mode,
            lambda: partial(
                flash_attention, causal=causal, window=window, softcap=softcap
            ),
        )

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        if not self.branchy:
            return self._fn(q, k, v)
        if self._flags.device != q.device:  # once per device after set_mode
            self._flags = self._flags.to(q.device)
        return self._fn(q, k, v, self._flags)

    @property
    def builds(self) -> int:
        """Specialisations built so far (0 for the branchy kernel)."""
        return self._table.stats.misses
