"""step_mfu.write: least device time of the ops' counted work over their measured time."""
from perfbench.measures import step_mfu_write_pct as read  # noqa: F401
