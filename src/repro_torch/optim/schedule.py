"""Learning-rate schedules, port of ``repro/optim/schedule.py`` (``:7-27``)."""
from __future__ import annotations

import numpy as np


def step_decay(init_lr: float, factor: float, every_steps: int):
    """Paper §4.1: lr starts at ``init_lr`` and is multiplied by ``factor``
    every ``every_steps`` steps.  Returns the float32 value as a float."""

    def fn(step: int) -> float:
        return float(np.float32(init_lr) * np.float32(factor) ** np.float32(step // every_steps))

    return fn


def warmup_cosine(init_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1):
    """Linear warm-up to ``init_lr`` (lr > 0 at step 0), then a cosine decay
    to ``min_ratio * init_lr`` at ``total_steps``.  Every operation is the
    reference's float32 one; the cosine is float64's rounded to float32,
    which XLA's float32 cosine is on all but about one step in 3,000 (1 ulp
    there).  Returns the float32 value as a float."""
    f32 = np.float32

    def fn(step: int) -> float:
        s = f32(step)
        if s < warmup_steps:
            val = (s + f32(1.0)) / f32(max(warmup_steps, 1))
        else:
            prog = np.clip((s - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
                           f32(0), f32(1))
            c = f32(np.cos(np.float64(f32(np.pi) * prog)))
            val = f32(min_ratio) + f32((1 - min_ratio) * 0.5) * (f32(1) + c)
        return float(f32(init_lr) * val)

    return fn
