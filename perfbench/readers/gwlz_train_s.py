"""gwlz_train_s: training seconds a GWLZ compress, from GWLZStats.seconds."""
from perfbench.measures import train_s as read  # noqa: F401
