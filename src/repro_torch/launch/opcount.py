"""Per-device FLOP and collective counts of an eager step, the
counterpart of ``repro/launch/hlowalk.py``.

The reference walks the partitioned HLO, which is one device's program,
and multiplies loop bodies by their trip counts.  Eager PyTorch has no
HLO: it runs every loop iteration, so counting the ops as they dispatch
is trip-count exact by construction.  :class:`OpCounter` is a
``TorchDispatchMode``.  On an op over DTensors it steps aside
(``NotImplemented``), so DTensor first turns the op into its local op on
this rank's shards and the collectives its placements need; the counter
then sees those, so every count is one device's (rank 0's), as the
reference's walked numbers are.  It counts

* dot and convolution FLOPs with hlowalk's definition, 2 · |result| ·
  contracted size, of ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
  ``dot``, ``convolution`` and ``convolution_backward`` (nothing else: an
  elementwise op, a softmax or a gather adds no FLOP, as in the
  reference's walk);
* every ``c10d_functional`` collective: its kind, result bytes, group
  size and the mesh dim it ran over (``wait_tensor`` is not one);
* launches of the port's kernels (custom ops in the ``repro_torch``
  namespace) and the elements they read.

It counts shapes, not values, so it runs over ``meta`` tensors as well as
real ones.  HLO text has no counterpart here, and neither has the
reference's ``parse_collectives`` (``repro/launch/dryrun.py:83-101``).
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd")


def wire_bytes(colls: list[dict]) -> float:
    """Per-device bytes on the wire by ring formulas (the reference's),
    from result bytes and group sizes."""
    total = 0.0
    for c in colls:
        g, b = max(c["group"], 1), c["bytes"]
        if g <= 1:
            continue
        if c["kind"] == "all-reduce":
            total += 2.0 * (g - 1) / g * b
        elif c["kind"] == "all-gather":
            total += (g - 1) / g * b
        elif c["kind"] == "reduce-scatter":
            total += (g - 1) * b  # result bytes are already 1/g of the input
        elif c["kind"] == "all-to-all":
            total += (g - 1) / g * b
        else:  # collective-permute
            total += b
    return total


def _numel(t) -> int:
    n = 1
    for s in t.shape:
        n *= int(s)
    return n


def _nbytes(t) -> int:
    return _numel(t) * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def dot_flops(func, args, out) -> float:
    """2 · |result| · contracted size of one dot or convolution op (0 for
    any other op)."""
    p = func.overloadpacket
    if p in (aten.mm, aten.bmm, aten.mv, aten.dot):
        return 2.0 * _numel(out) * args[0].shape[-1]
    if p in (aten.addmm, aten.baddbmm):
        return 2.0 * _numel(out) * args[1].shape[-1]
    if p is aten.convolution:
        weight = args[1]
        return 2.0 * _numel(out) * _numel(weight) / out.shape[1]
    if p is aten.convolution_backward:
        grad_out, inp, weight = args[0], args[1], args[2]
        grad_in, grad_w = out[0], out[1]
        flops = 0.0
        if grad_in is not None:  # the data-gradient convolution: kernel = weight
            flops += 2.0 * _numel(grad_in) * _numel(weight) / inp.shape[1]
        if grad_w is not None:  # the weight-gradient one: kernel = grad_out
            flops += 2.0 * _numel(grad_w) * _numel(grad_out) / grad_out.shape[1]
        return flops
    return 0.0


class OpCounter(TorchDispatchMode):
    """Counts one device's dot/convolution FLOPs, collectives and kernel
    launches while active (``with OpCounter(mesh) as oc: step(...)``).
    ``mesh`` (a ``DeviceMesh``, optional) names the mesh dim of each
    collective's group."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0.0
        self.collectives: list[dict] = []
        self.kernels: dict[str, dict] = {}
        self._dims: dict[str, str] = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._dims[mesh.get_group(i).group_name] = name

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor turns it into local ops and collectives first
        out = func(*args, **(kwargs or {}))
        # DTensor infers a new op's output shape by running it on fake
        # tensors: that call does no device's work
        if not any(isinstance(t, FakeTensor) for t in _tensors(args)):
            self._count(func, args, out)
        return out

    def _count(self, func, args, out) -> None:
        ns = func.namespace
        if ns == "aten":
            self.flops += dot_flops(func, args, out)
        elif ns in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_KINDS.get(func.overloadpacket._qualified_op_name.split("::")[-1])
            if kind is not None:
                self._collective(kind, args[-1], out)
        elif ns == "repro_torch":
            k = self.kernels.setdefault(func.overloadpacket.__name__,
                                        {"launches": 0, "elements": 0})
            k["launches"] += 1
            k["elements"] += sum(_numel(t) for t in _tensors(args))

    def _collective(self, kind: str, group_name: str, out) -> None:
        from torch.distributed.distributed_c10d import _resolve_process_group

        size = _resolve_process_group(group_name).size()
        self.collectives.append({
            "kind": kind, "bytes": sum(_nbytes(t) for t in _tensors(out)), "group": size,
            "mesh_dim": self._dims.get(group_name, f"group {group_name}")})

    def summary(self) -> dict:
        """``{"flops", "wire_bytes", "collectives": {kind: {count, bytes}},
        "wire_bytes_by_mesh_dim", "kernels"}`` (hlowalk's keys, plus the
        split by mesh dim and the kernels' launches)."""
        agg: dict[str, dict] = {}
        by_dim: dict[str, list] = {}
        for c in self.collectives:
            a = agg.setdefault(c["kind"], {"count": 0, "bytes": 0})
            a["count"] += 1
            a["bytes"] += c["bytes"]
            by_dim.setdefault(c["mesh_dim"], []).append(c)
        return {"flops": self.flops, "wire_bytes": wire_bytes(self.collectives),
                "collectives": agg,
                "wire_bytes_by_mesh_dim": {d: wire_bytes(cs) for d, cs in by_dim.items()},
                "kernels": self.kernels}
