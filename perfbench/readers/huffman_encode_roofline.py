"""huffman_encode_roofline: the encode kernel's bound over its traced time, in the profiled compress."""
from perfbench.measures import huffman_encode_pct as read  # noqa: F401
