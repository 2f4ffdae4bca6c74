"""Elastic restore, port of ``repro/runtime/elastic.py``.

Checkpoints store full logical arrays (no mesh in them), so moving a run
to other hardware is a restore with new placements.  On one card the new
"mesh" is a device: :func:`reshard_restore` restores onto it.  Sharding
specs for a multi-device mesh come with the port's distributed pieces
(ROADMAP.md Queue 1 item 10).  :func:`plan_remesh` is the reference's,
unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.manager import CheckpointManager


def reshard_restore(manager: CheckpointManager, target_tree, device, *,
                    step: int | None = None):
    """Restore ``target_tree``-shaped state onto ``device`` (each leaf keeps
    its target's dtype; the latest step unless ``step`` is given)."""
    return manager.restore(target_tree, step, device=torch.device(device))


def plan_remesh(old_mesh_shape: tuple, n_devices: int) -> tuple:
    """Pick the closest (data, model) factorization for the surviving
    devices, preserving the model-parallel degree when possible (weights
    keep their layout; only data parallelism shrinks)."""
    model = old_mesh_shape[-1]
    while n_devices % model != 0 and model > 1:
        model //= 2
    return (n_devices // model, model)
