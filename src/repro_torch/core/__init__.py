"""Dispatch core of the port: the semi-static dispatcher, lane registry,
shape buckets and telemetry (counterpart of ``repro.core``)."""

from .dispatch import (
    CompileCache,
    DispatchError,
    DispatchPolicy,
    Dispatcher,
)
from .specialization import bucket_multiple, bucket_pow2
from .telemetry import FlightRecorder, Histogram, MetricsRegistry, Telemetry

__all__ = [
    "CompileCache",
    "DispatchError",
    "DispatchPolicy",
    "Dispatcher",
    "FlightRecorder",
    "Histogram",
    "MetricsRegistry",
    "Telemetry",
    "bucket_multiple",
    "bucket_pow2",
]
