"""Fault tolerance of the port: heartbeats, the step-time watchdog and
semi-static failover (counterpart of ``repro.ft``)."""

from .failover import FailoverPlan, HeartbeatMonitor, StepTimeWatchdog

__all__ = ["FailoverPlan", "HeartbeatMonitor", "StepTimeWatchdog"]
