"""Learning-rate schedules, port of ``repro/optim/schedule.py``."""
from __future__ import annotations

import numpy as np


def step_decay(init_lr: float, factor: float, every_steps: int):
    """Paper §4.1: lr starts at ``init_lr`` and is multiplied by ``factor``
    every ``every_steps`` steps.  Returns the float32 value as a float."""

    def fn(step: int) -> float:
        return float(np.float32(init_lr) * np.float32(factor) ** np.float32(step // every_steps))

    return fn
