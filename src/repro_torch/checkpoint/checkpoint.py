"""Training checkpoints: atomic step directories and an async writer (the
port's copy of ``repro.checkpoint.checkpoint``), in the JAX package's
layout, so a checkpoint written by either package loads in the other.

Layout::

    <dir>/step_00000100.tmp/   (written)  ->  <dir>/step_00000100/  (rename)
        host_0000.npz        flat {path: array} of the whole state
        META.json            {"step": ..., "ts": ..., **meta}

Each host writes and reads its own ``host_{host_id:04d}.npz``
(``CheckpointManager(host_id=, num_hosts=)``, as the JAX package names it).
A state sharded over a mesh (``distributed.fsdp.ShardedTrainState``) is
saved as its joined, unsharded arrays, as the JAX package's
``jax.device_get`` saves a sharded state: so a checkpoint restores onto any
mesh (``runtime.steps.place_train_state``), the elastic re-mesh.

Keys are the JAX package's ``_flatten`` names of the same state: a
``TrainState``'s params are ``.params/blocks/0/attn/wk`` (the port's key
``blocks.0.attn.wk``), its moments ``.opt/.mu/...`` and ``.opt/.nu/...`` and
its step ``.opt/.step``; a dict's keys are path components, a dotted port
key standing for its nested path. A bfloat16 leaf is written as the raw
two-byte ``|V2`` array that ``np.savez`` makes of JAX's bfloat16, and a
``|V2`` array is read back by reinterpreting its bits as bfloat16, so no
``ml_dtypes`` is needed on either side.

``save`` snapshots the state to host memory synchronously and writes on a
thread, so the train loop never waits on the filesystem; ``restore``
resolves the latest complete step (``META.json`` present).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.distributed.fsdp import ShardedTrainState, unshard_state


def _walk(node: Any, path: str, leaf: Callable[[str, Any], Any]) -> Any:
    """Apply ``leaf(key, tensor)`` at every leaf of ``node`` (NamedTuples,
    dicts, lists, tensors) and rebuild the structure; ``key`` is the JAX
    package's path string of the leaf."""
    def at(part: str) -> str:
        return f"{path}/{part}" if path else part

    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_walk(getattr(node, f), at(f".{f}"), leaf)
                            for f in node._fields))
    if isinstance(node, dict):
        return {k: _walk(v, at(str(k).replace(".", "/")), leaf)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, at(str(i)), leaf)
                          for i, v in enumerate(node))
    return leaf(path, node)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().copy().view("V2")
    return t.numpy().copy()


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bfloat16 bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())  # a C-order copy, 0-d kept
    return t.to(device=like.device, dtype=like.dtype)


def flatten(state: Any) -> dict[str, np.ndarray]:
    """The state as ``{JAX path: numpy array}`` on the host (a sharded
    state's joined arrays)."""
    if isinstance(state, ShardedTrainState):
        state = unshard_state(state, device="cpu")
    flat: dict[str, np.ndarray] = {}

    def put(key: str, t: torch.Tensor) -> None:
        flat[key] = _to_numpy(t)

    _walk(state, "", put)
    return flat


def unflatten(template: Any, flat: dict) -> Any:
    """``template``'s structure with each leaf read from ``flat``, in the
    template leaf's shape, dtype and device."""
    def get(key: str, like: torch.Tensor) -> torch.Tensor:
        arr = flat[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)}, "
                             f"template {tuple(like.shape)}")
        return _to_tensor(arr, like)

    return _walk(template, "", get)


class CheckpointManager:
    def __init__(
        self,
        directory: str | Path,
        *,
        host_id: int = 0,
        num_hosts: int = 1,
        keep: int = 3,
        async_write: bool = True,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.keep = keep
        self.async_write = async_write
        self._pending: threading.Thread | None = None

    @property
    def _host_file(self) -> str:
        return f"host_{self.host_id:04d}.npz"

    # ----------------------------------------------------------------- save
    def save(self, step: int, state: Any, *, meta: dict | None = None) -> None:
        # snapshot synchronously (a host copy), write asynchronously
        flat = flatten(state)
        self.wait()
        if self.async_write:
            self._pending = threading.Thread(
                target=self._write, args=(step, flat, meta or {}), daemon=True
            )
            self._pending.start()
        else:
            self._write(step, flat, meta or {})

    def _write(self, step: int, flat: dict, meta: dict) -> None:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / self._host_file, **flat)
        (tmp / "META.json").write_text(
            json.dumps({"step": step, "ts": time.time(), **meta})
        )
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # -------------------------------------------------------------- restore
    def list_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "META.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None) -> tuple[int, Any]:
        """-> (step, the state read into ``template``'s structure, shapes,
        dtypes and devices). Raises ``FileNotFoundError`` with no complete
        checkpoint."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:08d}" / self._host_file
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        return step, unflatten(template, flat)
