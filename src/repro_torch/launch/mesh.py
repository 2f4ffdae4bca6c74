"""Production and host meshes, port of ``repro/launch/mesh.py``.

Functions, never module constants, and no process group is set up at
import.  The production meshes are H100 meshes built over the fake
backend's process group (``torch.testing._internal.distributed.fake_pg``):
one process stands for rank 0 of the whole mesh and no collective moves a
byte, the analogue of the reference's 512 host placeholder devices
(``repro/launch/dryrun.py:1-5``).  The fake group is process-global, so a
caller that builds one destroys it after (``dist.destroy_process_group``);
the dry run does so per cell.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.kernels.ops import resolve_device

SINGLE_POD = (32, 8)        # one DGX H100 SuperPOD scalable unit: 32 nodes x 8 GPUs
MULTI_POD = (2, 32, 8)      # two of them


def _world(n: int, backend: str) -> None:
    """A default process group of ``n`` ranks (this process rank 0): set
    up here if there is none, else checked."""
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks exists; "
                               f"this mesh needs {n}")
        return
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore

        store = FakeStore()
    else:
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=0, world_size=n)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(32, 8) over ("data", "model"): one SuperPOD scalable unit, ``model``
    inside a node's NVLink domain; (2, 32, 8) over ("pod", "data",
    "model"): two.  Over a fake process group of 256 or 512 ranks (set up
    if none exists), on ``cuda`` where a card is present, else ``cpu``:
    a dry run traces shapes (meta tensors) and moves no data, so the
    device type changes nothing it counts."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    _world(n, "fake")
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_host_mesh(device=None) -> DeviceMesh:
    """A (1, 1) ("data", "model") mesh on ``device`` (None: the CUDA
    device, which must exist), over a one-rank process group: the current
    one, or a new one (NCCL on the card, gloo on the CPU) over an
    in-process store."""
    device = resolve_device(device)
    _world(1, "nccl" if device.type == "cuda" else "gloo")
    return DeviceMesh(device.type, torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))


def batch_axes_of(mesh) -> tuple[str, ...]:
    """Mesh axes that carry data parallelism (a ``DeviceMesh``, or the
    reference's stand-in with ``axis_names``)."""
    names = mesh.mesh_dim_names if hasattr(mesh, "mesh_dim_names") else mesh.axis_names
    return tuple(a for a in names if a in ("pod", "data"))
