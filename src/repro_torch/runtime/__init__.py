"""Runtime fault tolerance (port of ``repro/runtime``).  ``ResilientLoop``
and the elastic restore wait for the checkpoint manager (ROADMAP.md Queue 1
item 9)."""
from repro_torch.runtime.fault import FailureInjector, RetryPolicy

__all__ = ["FailureInjector", "RetryPolicy"]
