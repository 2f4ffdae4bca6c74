"""Runtime fault tolerance and elastic restore (port of ``repro/runtime``)."""
from repro_torch.runtime.elastic import plan_remesh, reshard_restore
from repro_torch.runtime.fault import (
    FailureInjector,
    HeartbeatMonitor,
    ResilientLoop,
    RetryPolicy,
)

__all__ = [
    "plan_remesh",
    "reshard_restore",
    "FailureInjector",
    "HeartbeatMonitor",
    "ResilientLoop",
    "RetryPolicy",
]
