"""ratio: raw bytes over container bytes of the window's ops."""
from perfbench.measures import ratio as read  # noqa: F401
