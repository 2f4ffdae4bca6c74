"""compress_GBps: raw GB compressed per second of the window (host clock)."""
from perfbench.measures import rate_GBps as read  # noqa: F401
