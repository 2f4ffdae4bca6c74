"""Plain draw of the streaming writer's training reservoir (docs/STREAMING.md,
``core.trainer.TileReservoir``'s documented rule), written anew: which
tiles of a stream a bounded uniform sample keeps.

The stream offers its tiles in row-major grid order, one at a time.  The
first ``capacity`` tiles fill the slots in order; after that, the ``n``-th
tile offered (counting from 1) draws ``j = rng.integers(0, n)`` from
``numpy.random.default_rng(seed)`` and replaces slot ``j`` when ``j <
capacity`` (Algorithm R).  The default capacity is a quarter of the byte
budget over the bytes of one float32 (reconstruction, residual) tile pair,
at least 4.
"""
from __future__ import annotations

import math

import numpy as np


def default_capacity(mem_budget: int, tile) -> int:
    return max(4, (int(mem_budget) // 4) // (8 * math.prod(tile)))


def draw(n_tiles: int, capacity: int, seed: int) -> list[int]:
    """The tile id held in each slot once ``n_tiles`` tiles were offered."""
    rng = np.random.default_rng(seed)
    slots: list[int] = []
    for i in range(n_tiles):
        if len(slots) < capacity:
            slots.append(i)
        else:
            j = int(rng.integers(0, i + 1))
            if j < capacity:
                slots[j] = i
    return slots
