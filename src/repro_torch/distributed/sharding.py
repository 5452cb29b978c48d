"""Rule-based sharding and serving mesh plans: the port's copy of
``repro.distributed.sharding`` (DESIGN.md §5, §16-§17).

**The spec rules.** ``PARAM_RULES`` and the functions under them resolve a
partition spec for every leaf from its shape and a mesh's axis sizes alone:
TP over ``model`` (attention heads, the MLP's ``d_ff``, experts, vocab),
FSDP over ``data`` (the ``d_model``-ish dim of every weight), the batch over
``("pod", "data")``, and ZeRO over ``pod`` for optimiser moments. A dim is
sharded only where the axis divides it, so every config resolves (qwen3's
40 heads, granite's 49155-entry vocab). They work on the port's flat keys
(``"blocks.0.attn.wq"``; the rules match ``.`` where the JAX package's
pytree paths have ``/``), and on anything with a ``shape``: ``meta``
tensors do. A spec is a plain tuple with one entry per dim: an axis name,
a tuple of axis names (major to minor), or ``None``.

**The mesh.** JAX is single-controller: one process drives every device of
a ``Mesh``. The port keeps that model: a ``LogicalMesh`` is a grid of
logical devices (``torch.device`` s) driven from one process; each holds
its own shards, and each collective (``distributed.collectives``) is an
explicit tensor operation over the shards in a fixed order. One card may
be named several times: a 2x2 plan on one H100 is four logical devices
that are all ``cuda:0``, with no process group. ``shard`` and ``unshard``
split a tensor into the pieces its spec gives each coordinate and join
them back.

**Serving plans.** The engine treats the device topology as a dispatch
coordinate: every lane that touches a pool carries a trailing ``mesh`` name
("1x1", "2x2", "1x1@1", ... = data x model [@ device offset]), warmed like
any bucket ladder, so a topology change at run time is a copy of the live
state into the target cell's buffers plus a hot-slot flip, never a capture.
``MeshPlan`` owns one name's devices (``devices[off : off + dp·mp]`` of
``EngineConfig.devices``) and spec builders: TP-only params (``data``
stripped), per-slot rows over ``data``, dense caches and paged pools
(pages over ``data``, kv heads over ``model`` where they divide).

The JAX package's ``hint``/``use_shard_hints`` constrain GSPMD's layout of
activations; the port has no GSPMD. Its tensor-parallel forward
(``models.tensor_parallel``) lays every activation out explicitly from the
resolved specs and issues each collective where GSPMD put it, which takes
their place: the MoE tail's layout included, which is the one
``perf.moe_hints`` and ``perf.moe_weight_gather`` ask GSPMD for
(``models.moe.check_mesh_opts``). ``attn_q_split`` is ``hint_attn_q``'s
decision (heads, the query sequence under ``perf.seq_shard_fallback``, or
replicated), which the mesh's full-sequence attention reads
(``models.tensor_parallel._attend``).
"""

from __future__ import annotations

import itertools
import re
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import torch

SERVING_AXES = ("data", "model")

PART3 = "ROADMAP A12 part 3"

# (regex over the flat "a.b.c" key, [(neg dim index, [candidates in
# priority])]): the JAX package's table with "/" read as "."
PARAM_RULES: list[tuple[str, list[tuple[int, list[Any]]]]] = [
    (r"embed\.embedding$", [(-2, ["model"]), (-1, [("data", "model"), "data"])]),
    (r"head\.lm_head$", [(-1, ["model"]), (-2, [("data", "model"), "data"])]),
    (r"attn\.w[qkv]$", [(-2, ["model"]), (-3, ["data"])]),
    (r"attn\.wo$", [(-3, ["model"]), (-1, ["data"])]),
    (r"attn\.[qk]_scale$", []),
    (r"mlp\.w_(gate|up)$", [(-1, ["model"]), (-2, ["data"])]),
    (r"mlp\.w_down$", [(-2, ["model"]), (-1, ["data"])]),
    (r"moe\.router$", [(-2, ["data"])]),
    (r"moe\.w_(gate|up)$", [(-3, ["model"]), (-1, ["model"]), (-2, ["data"])]),
    (r"moe\.w_down$", [(-3, ["model"]), (-2, ["model"]), (-1, ["data"])]),
    (r"ssm\.w[zx]$", [(-1, ["model"]), (-2, ["data"])]),
    (r"ssm\.w[BC]$", [(-2, ["data"])]),
    (r"ssm\.wdt$", [(-1, ["model"]), (-2, ["data"])]),
    (r"ssm\.conv$", [(-1, ["model"])]),
    (r"ssm\.out$", [(-2, ["model"]), (-1, ["data"])]),
]


# ----------------------------------------------------------- logical mesh
class LogicalMesh:
    """The port's ``jax.sharding.Mesh``: axis names, axis sizes (``shape``,
    name -> size, in order) and a grid of ``torch.device`` s, one per
    coordinate (row-major). Devices may repeat: logical devices on one
    card. ``meta`` devices give a mesh that allocates nothing."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence[Any]):
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} do not match shape {shape}")
        devs = [torch.device(d) for d in devices]
        size = 1
        for s in shape:
            size *= s
        if len(devs) != size:
            raise ValueError(f"a {shape} mesh needs {size} devices, got "
                             f"{len(devs)}")
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self._coords = list(itertools.product(*(range(s) for s in shape)))
        self._devices = dict(zip(self._coords, devs))

    @property
    def size(self) -> int:
        return len(self._coords)

    def coords(self) -> list[tuple[int, ...]]:
        """Every coordinate, row-major."""
        return list(self._coords)

    def device(self, coord: tuple[int, ...]) -> torch.device:
        return self._devices[tuple(coord)]

    @property
    def devices(self) -> list[torch.device]:
        """The devices in coordinate order (row-major)."""
        return [self._devices[c] for c in self._coords]

    def axis(self, name: str) -> int:
        """The position of axis ``name`` in a coordinate."""
        return self.axis_names.index(name)

    def __repr__(self) -> str:
        return f"LogicalMesh({self.shape}, {sorted(set(map(str, self.devices)))})"


# ------------------------------------------------------------- the rules
def _axes_in_mesh(cand: Any, mesh) -> tuple[str, ...] | None:
    names = (cand,) if isinstance(cand, str) else tuple(cand)
    if all(n in mesh.axis_names for n in names):
        return names
    return None


def _axes_size(names: Sequence[str], mesh) -> int:
    s = 1
    for n in names:
        s *= mesh.shape[n]
    return s


def _entry(names: Sequence[str] | None):
    """A spec entry: one name bare, several as a tuple, none as None."""
    if not names:
        return None
    return names[0] if len(names) == 1 else tuple(names)


def _resolve(shape: tuple[int, ...], rule: list, mesh) -> tuple:
    assign: dict[int, tuple[str, ...]] = {}
    used: set[str] = set()
    for neg_dim, candidates in rule:
        dim = len(shape) + neg_dim
        if dim < 0:
            continue  # the tensor has fewer dims than the rule expects
        for cand in candidates:
            names = _axes_in_mesh(cand, mesh)
            if names is None or any(n in used for n in names):
                continue
            if shape[dim] % _axes_size(names, mesh) == 0 and shape[dim] > 0:
                assign[dim] = names
                used.update(names)
                break
    return tuple(_entry(assign.get(d)) for d in range(len(shape)))


def _shape(leaf) -> tuple[int, ...]:
    return tuple(int(s) for s in leaf.shape)


def param_pspec_tree(params_shape: Mapping[str, Any], mesh) -> dict:
    """A spec per flat param key (leaves: tensors, ``meta`` tensors or
    anything with a ``shape``); norms, scalars and biases replicated."""
    out = {}
    for key, leaf in params_shape.items():
        shape = _shape(leaf)
        out[key] = (None,) * len(shape)
        for pat, rule in PARAM_RULES:
            if re.search(pat, key):
                out[key] = _resolve(shape, rule, mesh)
                break
    return out


def opt_pspec_tree(cfg, param_specs: Mapping[str, tuple],
                   params_shape: Mapping[str, Any], mesh) -> dict:
    """Moment specs = param specs, optionally ZeRO'd over the pod axis: the
    first ``data`` dim that ``("data", ..., "pod")`` still divides takes
    ``pod`` too."""
    if not (cfg.zero_over_pod and "pod" in mesh.axis_names):
        return dict(param_specs)

    def upgrade(spec: tuple, shape: tuple[int, ...]) -> tuple:
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i, (p, size) in enumerate(zip(parts, shape)):
            names = (p,) if isinstance(p, str) else tuple(p or ())
            if "data" in names and "pod" not in names:
                new = names + ("pod",)
                if size % _axes_size(new, mesh) == 0:
                    parts[i] = new
                    return tuple(parts)
        return tuple(parts)

    return {k: upgrade(s, _shape(params_shape[k]))
            for k, s in param_specs.items()}


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _first_divisible(size: int, chains: list, mesh):
    for cand in chains:
        names = _axes_in_mesh(cand, mesh)
        if names and size % _axes_size(names, mesh) == 0:
            return names if len(names) > 1 else names[0]
    return None


def data_pspec(shape: tuple[int, ...], mesh) -> tuple:
    """Inputs/labels [B, S, ...]: batch over (pod, data) when divisible."""
    b = _first_divisible(shape[0], [("pod", "data"), "data", "pod"], mesh)
    return (b,) + (None,) * (len(shape) - 1)


def cache_pspec_tree(cfg, cache_shape: Sequence[Mapping[str, Any]],
                     mesh) -> list[dict]:
    """Dense cache specs (per period slot, leaves stacked ``[m, ...]``):
    KV ``[m,B,S,KH,dh]`` batch over (pod, data) and sequence over model; at
    B = 1 (long context) the sequence takes every axis there is. A mamba
    slot's conv ``[m,B,K-1,C]`` and state ``[m,B,H,P,N]``: batch, and
    channels or heads over model."""
    out = []
    for slot_cache in cache_shape:
        specs = {}
        for name, leaf in slot_cache.items():
            shape = _shape(leaf)
            parts: list = [None] * len(shape)
            b = _first_divisible(shape[1], [("pod", "data"), "data"], mesh)
            parts[1] = b
            if name in ("k", "v"):
                seq_chains = (
                    ["model"] if b is not None
                    else [("pod", "data", "model"), ("data", "model"),
                          "model"])
                parts[2] = _first_divisible(shape[2], seq_chains, mesh)
            elif name == "conv":
                parts[3] = _first_divisible(shape[3], ["model"], mesh)
            elif name == "state":
                parts[2] = _first_divisible(shape[2], ["model"], mesh)
            specs[name] = tuple(parts)
        out.append(specs)
    return out


def attn_q_split(num_heads: int, seq: int, mp: int,
                 fallback: bool | None = None) -> str | None:
    """How full-sequence attention's ``q`` and ``o`` ``[B, S, H, dh]`` lie
    over a ``model`` axis of ``mp`` devices (the JAX package's
    ``hint_attn_q``): ``"heads"`` where ``mp`` divides the heads; else, with
    ``fallback`` (default ``perf.current().seq_shard_fallback``) and ``mp``
    dividing ``seq``, ``"seq"`` (each shard the queries of its ``S / mp``
    rows: context-parallel attention for qwen3's 40 heads, musicgen's 24
    and internvl2's 14 on a 16-way axis); else None (replicated)."""
    if mp <= 1:
        return None
    if num_heads % mp == 0:
        return "heads"
    if fallback is None:
        from repro_torch import perf

        fallback = perf.current().seq_shard_fallback
    if fallback and seq % mp == 0:
        return "seq"
    return None


def _strip_axes(spec: tuple, drop: tuple[str, ...]) -> tuple:
    parts: list = []
    for p in tuple(spec):
        names = (p,) if isinstance(p, str) else tuple(p or ())
        keep = tuple(n for n in names if n not in drop)
        parts.append(keep[0] if len(keep) == 1 else (keep or None))
    return tuple(parts)


def spec_axes(entry) -> tuple[str, ...]:
    """A spec entry's axis names (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def splits(spec: tuple, axis: str) -> bool:
    """Whether ``spec`` shards some dim over ``axis``."""
    return any(axis in spec_axes(e) for e in spec)


# ------------------------------------------------- pieces of a tensor
def local_shape(shape: Sequence[int], spec: tuple, mesh) -> tuple[int, ...]:
    """The shape of one coordinate's piece of a ``shape`` tensor."""
    return tuple(int(s) // _axes_size(spec_axes(e), mesh)
                 for s, e in zip(shape, tuple(spec) + (None,) * len(shape)))


def shard_slices(shape: Sequence[int], spec: tuple, mesh,
                 coord: tuple[int, ...]) -> tuple[slice, ...]:
    """The global index range a coordinate's piece holds: along each dim
    sharded over axes (a, b, ...), chunk ``i_a · |b| + i_b`` (the first
    axis major), as ``NamedSharding`` lays it out."""
    out = []
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for size, entry in zip(shape, spec):
        names = spec_axes(entry)
        idx, n = 0, 1
        for name in names:
            idx = idx * mesh.shape[name] + coord[mesh.axis(name)]
            n *= mesh.shape[name]
        step = int(size) // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard(tensor: torch.Tensor, spec: tuple, mesh) -> dict:
    """``tensor`` split into every coordinate's piece (a contiguous copy on
    the coordinate's device)."""
    shape = tuple(tensor.shape)
    return {c: tensor[shard_slices(shape, spec, mesh, c)].to(
                mesh.device(c), copy=True).contiguous()
            for c in mesh.coords()}


def unshard(pieces: Mapping[tuple, torch.Tensor], spec: tuple, mesh,
            device: torch.device | str | None = None) -> torch.Tensor:
    """The global tensor joined back from every coordinate's piece, on
    ``device`` (default the first coordinate's). Replicated pieces are
    equal; each lands where its slices say."""
    first = pieces[mesh.coords()[0]]
    shape = tuple(s * _axes_size(spec_axes(e), mesh)
                  for s, e in zip(first.shape,
                                  tuple(spec) + (None,) * first.dim()))
    dev = torch.device(device) if device is not None else first.device
    out = torch.empty(shape, dtype=first.dtype, device=dev)
    for c in mesh.coords():
        out[shard_slices(shape, spec, mesh, c)] = pieces[c].to(dev)
    return out


# ------------------------------------------------------- mesh names
def parse_mesh_name(name: str) -> tuple[int, int]:
    """"2x2" / "2,2" -> (dp, mp). Offset slice names ("1x1@1") parse to the
    same (dp, mp) shape; ``parse_slice_name`` keeps the offset."""
    return parse_slice_name(name)[:2]


def parse_slice_name(name: str) -> tuple[int, int, int]:
    """"DPxMP[@OFF]" -> (dp, mp, off): an ordinary DPxMP mesh placed at
    device offset OFF (DESIGN.md §17). Plain names carry offset 0."""
    body, _, off_s = str(name).strip().lower().partition("@")
    parts = re.split(r"[x,]", body)
    if len(parts) != 2:
        raise ValueError(
            f"mesh name must be 'DPxMP[@OFF]' (e.g. '1x2', '1x1@1'), "
            f"got {name!r}"
        )
    try:
        dp, mp = int(parts[0]), int(parts[1])
        off = int(off_s) if off_s else 0
    except ValueError as e:
        raise ValueError(
            f"mesh name must be 'DPxMP[@OFF]', got {name!r}"
        ) from e
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {name!r}")
    if off < 0:
        raise ValueError(f"mesh offset must be >= 0, got {name!r}")
    return dp, mp, off


def mesh_name(dp: int, mp: int, off: int = 0) -> str:
    return f"{dp}x{mp}" if off == 0 else f"{dp}x{mp}@{off}"


class MeshPlan:
    """One serving-mesh coordinate over the engine's logical devices.

    ``single`` plans ("1x1") run on the engine's own device, the exact
    pre-mesh path. One-device offset slices ("1x1@1") are ``solo``: pinned
    to ``device`` = ``devices[off]``. A plan of ``dp·mp > 1`` devices has a
    ``LogicalMesh`` (``mesh``) of shape (dp, mp) over ``devices[off : off +
    dp·mp]``. Past the list, ``device`` and ``mesh`` raise ``ValueError``
    (no missing device is mapped onto another without being told to)."""

    def __init__(self, name: str, devices: Sequence[str] = ()):
        self.dp, self.mp, self.offset = parse_slice_name(name)
        self.name = mesh_name(self.dp, self.mp, self.offset)
        self.devices = tuple(devices)
        self._mesh: LogicalMesh | None = None

    @property
    def single(self) -> bool:
        return self.dp == 1 and self.mp == 1 and self.offset == 0

    @property
    def solo(self) -> bool:
        """One device at any offset."""
        return self.dp == 1 and self.mp == 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.mp

    @property
    def device(self):
        """The device a solo plan is pinned to (a multi-device plan's first
        device: where its step's inputs and outputs live)."""
        if not self.solo:
            return self.mesh.device((0, 0))
        avail = len(self.devices)
        if self.offset >= avail:
            raise ValueError(
                f"mesh {self.name!r} needs device {self.offset}, only "
                f"{avail} listed ({self.devices}); list more in "
                f"EngineConfig.devices (one device may be named twice)"
            )
        return self.devices[self.offset]

    @property
    def mesh(self) -> LogicalMesh:
        if self._mesh is None:
            avail = len(self.devices)
            if self.offset + self.num_devices > avail:
                raise ValueError(
                    f"mesh {self.name!r} needs devices "
                    f"[{self.offset}, {self.offset + self.num_devices}), "
                    f"only {avail} listed ({self.devices}); list more in "
                    f"EngineConfig.devices (one device may be named "
                    f"several times)"
                )
            self._mesh = LogicalMesh(
                (self.dp, self.mp), SERVING_AXES,
                self.devices[self.offset:self.offset + self.num_devices])
        return self._mesh

    # --- spec builders (plain tuples; ``mesh``-free: dp and mp suffice) ---
    def param_specs(self, params_shape: Mapping[str, Any]) -> dict:
        """TP-only param specs: ``PARAM_RULES`` with the FSDP ('data')
        assignments stripped. Serving replicates weights across the data
        axis; only 'model' splits them."""
        axes = LogicalMesh((self.dp, self.mp), SERVING_AXES,
                           ["meta"] * self.num_devices)
        specs = param_pspec_tree(params_shape, axes)
        return {k: _strip_axes(s, ("data", "pod")) for k, s in specs.items()}

    def row_spec(self, shape: tuple[int, ...]) -> tuple:
        """Per-slot arrays (tok [S,1], pos [S], bt [S,PB], keys [S,2]):
        slots over 'data' when divisible, else replicated."""
        parts: list = [None] * len(shape)
        if shape and shape[0] % self.dp == 0:
            parts[0] = "data"
        return tuple(parts)

    def dense_cache_specs(self, cache_shape: Sequence[Mapping]) -> list:
        """Dense per-slot caches (leaves stacked [m, S, ...]): slots over
        'data'; attention KV [m,S,L,KH,dh] also takes heads over 'model'
        when divisible (falling back to the seq dim, flash-decode style)."""
        out = []
        for slot_cache in cache_shape:
            specs = {}
            for name, leaf in slot_cache.items():
                shape = _shape(leaf)
                parts: list = [None] * len(shape)
                if len(shape) >= 2 and shape[1] % self.dp == 0:
                    parts[1] = "data"
                if name in ("k", "v") and len(shape) == 5:
                    if shape[3] % self.mp == 0:
                        parts[3] = "model"
                    elif shape[2] % self.mp == 0:
                        parts[2] = "model"
                specs[name] = tuple(parts)
            out.append(specs)
        return out

    def paged_cache_specs(self, cache_shape: Sequence[Mapping]) -> list:
        """Paged pools (kv leaves [m, P, ps, KH, dh], int8 scale leaves
        [m, P, ps]): the physical page axis over 'data' (the host-side pool
        hands each shard a contiguous page block, ``kvcache.PagePool``),
        heads over 'model' when divisible."""
        out = []
        for slot_cache in cache_shape:
            specs = {}
            for name, leaf in slot_cache.items():
                shape = _shape(leaf)
                parts: list = [None] * len(shape)
                if len(shape) >= 2 and shape[1] % self.dp == 0:
                    parts[1] = "data"
                if len(shape) == 5 and shape[3] % self.mp == 0:
                    parts[3] = "model"
                specs[name] = tuple(parts)
            out.append(specs)
        return out

    def __repr__(self) -> str:
        return f"MeshPlan({self.name!r})"


@dataclass(frozen=True)
class DisaggPlan:
    """Disaggregated prefill/decode placement (DESIGN.md §17): the prefill
    lanes (``LaneSpec.slice == "prefill"``) pin to ``prefill``, everything
    else to ``decode``. Both names must sit in the engine's warmed mesh
    ladder; the split is then a rebind (``set_disagg``), never a capture.
    The two slices' device offsets must not overlap."""

    prefill: str
    decode: str

    def __post_init__(self) -> None:
        pf, dec = MeshPlan(self.prefill), MeshPlan(self.decode)
        pf_devs = set(range(pf.offset, pf.offset + pf.num_devices))
        dec_devs = set(range(dec.offset, dec.offset + dec.num_devices))
        if pf_devs & dec_devs:
            raise ValueError(
                f"disagg slices overlap: prefill {self.prefill!r} and "
                f"decode {self.decode!r} share devices "
                f"{sorted(pf_devs & dec_devs)}"
            )
        object.__setattr__(self, "prefill", pf.name)
        object.__setattr__(self, "decode", dec.name)

    @classmethod
    def split(cls, base: "MeshPlan | str") -> "DisaggPlan":
        """The canonical split of a base mesh: its last data-parallel row
        becomes the prefill slice, the rest keep decoding ("2x1" -> decode
        "1x1" + prefill "1x1@1")."""
        plan = base if isinstance(base, MeshPlan) else MeshPlan(base)
        if plan.dp < 2:
            raise ValueError(
                f"disagg split needs dp >= 2 on the base mesh, got "
                f"{plan.name!r} (one data row must become the prefill slice)"
            )
        dec_dp = plan.dp - 1
        return cls(
            prefill=mesh_name(1, plan.mp, plan.offset + dec_dp * plan.mp),
            decode=mesh_name(dec_dp, plan.mp, plan.offset),
        )
