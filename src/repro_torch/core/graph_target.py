"""CUDA-graph branch targets: the port's counterpart of the JAX package's
AOT-compiled executable (``jit(...).lower(...).compile()``).

A ``GraphTarget`` holds one step captured once, on the cold path, as a
``torch.cuda.CUDAGraph`` over static input and output buffers. Taking the
branch (the hot path) checks the arguments against the static inputs,
copies in the ones that are not already the static tensors, and replays
the graph: one graph launch however many kernels the step issues.

Capture, in order: allocate the static inputs (outside any graph pool, so
no replay of another graph can overwrite them); run the step once on a side
stream, so every kernel's first-call host work — its build, its library
load, its shared-memory opt-in, an encoded tensor map — happens outside the
capture; capture the step; keep its outputs as the static outputs and record
their ``(shape, dtype)``. A capture that fails raises: there is no eager
fallback.

Two contracts follow from replaying into fixed memory:

* A static output is valid until the next replay of any graph that shares
  its memory pool (an engine's graphs share one; they never run
  concurrently). Read it, copy it, or pull it to the host before then.
* ``chain`` maps an output to an input of the same target: the step's
  output is copied into that static input inside the graph, and the target
  returns the static input in the output's place. The next call that passes
  it back copies nothing (a decode step's next token and position).

``owned`` is the state the step updates in place (a paged pool, a burst
cache): the capture reads and writes its tensors, so the target is bound to
them, and an output that *is* ``owned`` is returned as that same object.

The kernels' launch counts (``repro_torch.kernels``) stay true under graphs:
the capture's own increments (it records launches, it does not run them)
are taken back, and every replay adds the launches the graph holds.
"""

from __future__ import annotations

import gc
from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree as pytree

# eager runs of the step on a side stream before its capture
WARMUP_RUNS = 1


def check_args(specs: Sequence[tuple], args: Sequence[Any],
               device: torch.device) -> None:
    """Raise ``ValueError`` unless every argument is a tensor of exactly the
    ``(name, shape, dtype)`` of its spec on ``device``. A graph's inputs
    are copied in with ``copy_``, which broadcasts and casts silently, so
    this check comes before any copy."""
    if len(args) != len(specs):
        raise ValueError(f"expected {len(specs)} inputs, got {len(args)}")
    for (name, shape, dtype), t in zip(specs, args):
        if not isinstance(t, torch.Tensor):
            raise ValueError(
                f"{name}: expected a tensor, got {type(t).__name__}"
            )
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
            raise ValueError(
                f"{name}: expected {shape} {dtype} on {device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )


def _signature(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), leaf.dtype)
    return leaf


def _launch_counts() -> dict:
    # imported here: the kernels package imports core (KernelBranch's table)
    from repro_torch.kernels import KERNELS

    return {k: k.launches for k in KERNELS}


class GraphTarget:
    """One step captured as a CUDA graph over static buffers.

    ``step(*inputs)`` is called with the static inputs; ``example_inputs``
    (tensors on one CUDA device) fix their shapes and dtypes, and their
    values are the warmup's and the capture's inputs. ``static_inputs``
    lets several targets share one set (a ``BranchChanger``'s branches);
    ``pool`` is a ``torch.cuda.graph_pool_handle()`` shared by targets that
    never run concurrently; ``names`` label the inputs in guard errors."""

    def __init__(
        self,
        step: Callable,
        example_inputs: Sequence[torch.Tensor],
        *,
        owned: Any = None,
        pool: Any = None,
        chain: dict | None = None,
        names: Sequence[str] | None = None,
        static_inputs: Sequence[torch.Tensor] | None = None,
        name: str = "graph",
    ):
        if not example_inputs or not all(
            isinstance(t, torch.Tensor) for t in example_inputs
        ):
            raise ValueError(f"{name}: a graph target takes tensor inputs")
        self.device = example_inputs[0].device
        names = list(names or [f"input {i}" for i in range(len(example_inputs))])
        self.name = name
        self.owned = owned
        self._step = step
        self._pool = pool
        self._chain = dict(chain or {})
        self._specs = tuple(
            (n, tuple(t.shape), t.dtype) for n, t in zip(names, example_inputs)
        )
        if static_inputs is None:
            static_inputs = tuple(t.detach().clone() for t in example_inputs)
        else:
            check_args(self._specs, static_inputs, self.device)
        self.static_inputs = tuple(static_inputs)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.static_outputs: list | None = None
        self.out_signature: Any = None
        self.replays = 0
        self._launches: tuple = ()
        self._result: Any = None

    def _run(self) -> Any:
        out = self._step(*self.static_inputs)
        for o, i in self._chain.items():
            src = out[o] if isinstance(out, tuple) else None
            dst = self.static_inputs[i]
            if _signature(src) != (tuple(dst.shape), dst.dtype):
                raise ValueError(
                    f"{self.name}: chained output {o} does not match input "
                    f"{self._specs[i][0]} {_signature(dst)}"
                )
            dst.copy_(src)
        return out

    def capture(self) -> "GraphTarget":
        """Warm the step on a side stream, then capture it (cold path)."""
        dev = self.device
        if dev.type != "cuda":
            raise ValueError(
                f"{self.name}: CUDA graphs capture CUDA tensors, got inputs "
                f"on {dev}"
            )
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self._run()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        # No garbage collection inside the capture: collecting an unused
        # engine's graphs destroys them, which a capturing stream refuses
        # (the capture is then invalidated).
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out = self._run()
        except Exception as e:
            raise RuntimeError(
                f"{self.name}: CUDA graph capture failed: {e}"
            ) from e
        finally:  # a capture records launches; it runs none
            if collecting:
                gc.enable()
            after = _launch_counts()
            for k, n in before.items():
                k.launches = n
        self._launches = tuple(
            (k, after[k] - n) for k, n in before.items() if after[k] != n
        )
        self.graph = graph
        self._result = self._bind_outputs(out)
        return self

    def _bind_outputs(self, out: Any) -> Any:
        """Keep the captured outputs as the static outputs, record their
        signature and build the value every call returns: ``owned`` in its
        own place, a chained output's static input in the output's."""
        top = isinstance(out, tuple)
        owned_at = {
            i for i, o in enumerate(out) if o is self.owned
        } if top and self.owned is not None else set()
        tree = tuple(
            None if i in owned_at else o for i, o in enumerate(out)
        ) if owned_at else out
        leaves, spec = pytree.tree_flatten(tree)
        self.static_outputs = leaves
        self.out_signature = pytree.tree_unflatten(
            [_signature(x) for x in leaves], spec
        )
        result = pytree.tree_unflatten(leaves, spec)
        if not top:
            return result
        return tuple(
            self.owned if i in owned_at
            else self.static_inputs[self._chain[i]] if i in self._chain
            else r
            for i, r in enumerate(result)
        )

    def __call__(self, *args: torch.Tensor) -> Any:
        """Hot path: guard, copy in what is not already static, replay."""
        graph = self.graph
        if graph is None:
            raise RuntimeError(f"{self.name}: capture() before calling")
        check_args(self._specs, args, self.device)
        for s, a in zip(self.static_inputs, args):
            if a is not s:
                s.copy_(a)
        graph.replay()
        self.replays += 1
        for k, n in self._launches:
            k.launches += n
        return self._result
