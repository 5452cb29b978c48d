"""Dispatch core of the port: semi-static conditions (the paper's
contribution) on PyTorch + CUDA, the counterpart of ``repro.core``.

Four layers (DESIGN.md §2-§3):
  * host level     - BranchChanger: fixed fan-out of captured branch targets
                     (CUDA graphs, ``graph_target``) + direct-call hot path
  * dispatch level - Dispatcher: open fan-out CompileCache + hot slot + policy
  * host decisions - semi_static / semi_static_switch: run only the taken
                     branch, on a host value
  * kernel level   - specialised CUDA kernels (see repro_torch.kernels)
plus the lane registry, shape buckets and telemetry.
"""

from .dispatch import (
    CacheStats,
    CompileCache,
    DispatchError,
    DispatchPolicy,
    DispatchStats,
    Dispatcher,
    live_dispatchers,
    reset_dispatchers,
)
from .graph_target import GraphTarget
from .lanes import (
    LANES,
    DispatchKey,
    LaneAxis,
    LaneRegistry,
    LaneSpec,
    UnknownLaneError,
)
from .semistatic import (
    BranchChanger,
    BranchChangerError,
    SwitchStats,
    live_entry_points,
)
from .semistatic import reset_entry_points as _reset_branch_changers
from .specialization import SpecStats, SpecTable, bucket_multiple, bucket_pow2
from .telemetry import (
    FlightRecorder,
    Histogram,
    MetricsRegistry,
    Telemetry,
)
from .tracing import semi_static, semi_static_switch


def reset_entry_points() -> None:
    """Test hook: forget all live entry points (BranchChangers + Dispatchers)."""
    _reset_branch_changers()
    reset_dispatchers()


__all__ = [
    "BranchChanger",
    "BranchChangerError",
    "CacheStats",
    "CompileCache",
    "DispatchError",
    "DispatchKey",
    "DispatchPolicy",
    "DispatchStats",
    "Dispatcher",
    "GraphTarget",
    "LANES",
    "LaneAxis",
    "LaneRegistry",
    "LaneSpec",
    "UnknownLaneError",
    "FlightRecorder",
    "Histogram",
    "MetricsRegistry",
    "Telemetry",
    "SpecStats",
    "SpecTable",
    "SwitchStats",
    "bucket_multiple",
    "bucket_pow2",
    "live_dispatchers",
    "live_entry_points",
    "reset_dispatchers",
    "reset_entry_points",
    "semi_static",
    "semi_static_switch",
]
