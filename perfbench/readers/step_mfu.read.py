"""step_mfu.read: least device time of the decodes' counted work over their measured time."""
from perfbench.measures import step_mfu_read_pct as read  # noqa: F401
