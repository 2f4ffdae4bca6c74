"""Optimizer and schedule of the enhancer trainer (port of ``repro/optim``)."""
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["AdamWConfig"]
