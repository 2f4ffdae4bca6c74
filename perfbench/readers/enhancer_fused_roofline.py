"""enhancer_fused_roofline: the group-wise enhancer kernel's bound over its traced time, in the profiled decode."""
from perfbench.measures import enhancer_fused_pct as read  # noqa: F401
