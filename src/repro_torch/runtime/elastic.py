"""Elastic restore, port of ``repro/runtime/elastic.py``.

Checkpoints store full logical arrays (no mesh in them), so moving a run
to other hardware is a restore with new placements: build the new mesh,
recompute the specs against it (the divisibility-aware rules drop axes
that no longer fit), and place each leaf by its spec.  The same path
serves shrink (node loss) and grow (capacity arrival).  On one card the
target may be a device instead.  :func:`plan_remesh` is the reference's,
unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import sharding as SH


def reshard_restore(manager: CheckpointManager, target_tree, mesh_or_device, *,
                    step: int | None = None, opts: SH.ShardingOptions | None = None):
    """Restore ``target_tree``-shaped state (the latest step unless ``step``
    is given; each leaf keeps its target's dtype).  On a ``DeviceMesh``
    every leaf comes back as a DTensor placed by ``param_pspecs`` under
    ``opts``; on a device, as a tensor there."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh_or_device, DeviceMesh):
        return manager.restore(target_tree, step, device=torch.device(mesh_or_device))
    mesh = mesh_or_device
    pspecs = SH.param_pspecs(target_tree, opts or SH.ShardingOptions(), mesh)
    return manager.restore(target_tree, step, mesh=mesh, placements=SH.named(mesh, pspecs))


def plan_remesh(old_mesh_shape: tuple, n_devices: int) -> tuple:
    """Pick the closest (data, model) factorization for the surviving
    devices, preserving the model-parallel degree when possible (weights
    keep their layout; only data parallelism shrinks)."""
    model = old_mesh_shape[-1]
    while n_devices % model != 0 and model > 1:
        model //= 2
    return (n_devices // model, model)
