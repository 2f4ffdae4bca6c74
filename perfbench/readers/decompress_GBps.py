"""decompress_GBps: raw GB decoded whole per second of the window (host clock)."""
from perfbench.measures import rate_GBps as read  # noqa: F401
