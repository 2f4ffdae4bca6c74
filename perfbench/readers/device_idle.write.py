"""device_idle.write: share of the profiled span with no kernel or copy on the card."""
from perfbench.measures import device_idle_pct as read  # noqa: F401
