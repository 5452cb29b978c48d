"""Turn the JAX package's parameter tree into the port's parameters.

``params_from_jax`` takes the output of ``repro.models.init_params`` after
the *caller* converted its leaves to numpy (this module imports neither jax
nor ``repro``) and returns the port's flat ``dict[str, Tensor]`` with the
same layout, keyed by the tree path (``"blocks.0.attn.wq"``), so both
packages compute on identical weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def params_from_jax(tree: Any, device: torch.device | str = "cpu") -> dict:
    """Nested dicts/lists of numpy arrays -> ``{"a.b.0.c": Tensor}``."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Any, path: tuple) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out[".".join(path)] = _tensor(node).to(device)

    walk(tree, ())
    return out
