"""setup_s: seconds from the harness's start to the window's (loading, warm-up, the traffic's own set-up)."""
from perfbench.measures import setup_s as read  # noqa: F401
