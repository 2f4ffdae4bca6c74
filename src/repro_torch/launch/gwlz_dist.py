"""Distributed GWLZ: the paper's group-wise enhancer training as one step
over a global slice batch, port of ``repro/launch/gwlz_dist.py``.

In the reference the step is an SPMD program: slices on the data axes,
the group axis on ``model`` (groups are independent, so no cross-group
collective exists), gradients optionally through the error-bounded int8
compression (``optim/grad_compress.py``).  :func:`make_dist_train_step`
returns the step on one device, or with a ``mesh`` (a ``DeviceMesh``)
the per-device program over DTensor trees placed by
:func:`state_pspecs` and :func:`batch_pspecs`: each device runs its own
groups (G / |model| of them) on its own slices, sums the per-group
statistics it needs over the batch axes (BN's sums and counts, the loss's
squared errors and pixel counts: synchronized BN), and all-reduces the
gradients over the batch axes before the update.  The dry run traces
this program (``launch/dryrun.py``, the gwlz-nyx cell).

The step is not ``core/trainer.py::train_step``: it assigns groups inside
the step (``group_hist``, one launch a step), sums every group's loss with
no ``active`` weighting, uses the default ``AdamWConfig()`` at
``cfg.lr``, and compresses the gradients between the backward and the
AdamW update when ``cfg.grad_compress`` is set.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import tree
from repro_torch.core import enhancer, grouping
from repro_torch.core.enhancer import GroupEnhancers, fp32_convs
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.mesh import batch_axes_of
from repro_torch.launch.sharding import P
from repro_torch.models.spmd import all_reduce_over
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.optim.grad_compress import GradCompressConfig, init_ef
from repro_torch.optim.grad_compress import apply as gc_apply


@dataclass(frozen=True)
class DistGWLZConfig:
    n_groups: int = 32          # the reference pads to a multiple of its model axis
    channels: int = 9
    volume: int = 512           # Nyx: 512^3
    batch_slices: int = 64      # global slice batch per step
    lr: float = 1e-3
    grad_compress: bool = False
    gc_rel_eb: float = 1e-2


def build_state(cfg: DistGWLZConfig, *, enhancers: GroupEnhancers | None = None,
                generator: torch.Generator | None = None, device=None) -> dict:
    """``{"params", "bn", "opt", "ef"}`` in the reference's layout (leading
    [G] leaves): the parameters and BN buffers of ``enhancers`` (default:
    new ones drawn from ``generator``, on ``device``), fp32 AdamW state,
    and zero error feedback when ``cfg.grad_compress`` is set (else None)."""
    if enhancers is None:
        enhancers = GroupEnhancers(cfg.n_groups, cfg.channels, generator=generator,
                                   device=resolve_device(device))
    params = enhancers.params()
    return {"params": params, "bn": enhancers.state(), "opt": adamw.init(params, AdamWConfig()),
            "ef": init_ef(params) if cfg.grad_compress else None}


def _group_inputs(xb, ids, edges, g0: int, n: int):
    """Normalised, masked inputs [n, B, H, W] (and masks) of groups g0 ..
    g0 + n - 1 (``core/trainer.py::_group_inputs`` for a run of groups)."""
    lo, scale = grouping.group_normalizers(edges[g0:g0 + n + 1])
    masks = (ids.unsqueeze(0) == torch.arange(g0, g0 + n, device=ids.device).view(
        (-1,) + (1,) * ids.ndim)).to(xb.dtype)
    xn = (xb[None] - lo[:, None, None, None]) / scale[:, None, None, None]
    return xn * masks, masks


class _SyncSum(torch.autograd.Function):
    """A per-device partial summed over mesh dims, its gradient summed the
    same way (each device's loss share reads the total)."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return all_reduce_over(t, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_over(g, ctx.mesh, ctx.dims), None, None


def make_dist_train_step(cfg: DistGWLZConfig, device=None, mesh=None):
    """Returns ``train_step(state, batch) -> (state, losses [G])``.  ``batch``
    is ``{"x": [B, H, W] decompressed slices, "r": [B, H, W] residuals,
    "edges": [G+1], "rscale": [G]}`` (tensors or arrays, moved to
    ``device``, None: the CUDA device).  The state's tensors are updated in
    place.  With ``mesh``, ``state`` and ``batch`` are DTensors on it
    (:func:`state_pspecs`, :func:`batch_pspecs`) and the losses come back
    as one too (sharded on ``model``)."""
    device = resolve_device(device)
    G = cfg.n_groups
    gc_cfg = GradCompressConfig(rel_eb=cfg.gc_rel_eb, enabled=cfg.grad_compress)
    adam_cfg = AdamWConfig()

    def local_step(state: dict, batch: dict, g0: int, sync):
        xb, rb, edges, rscale = (torch.as_tensor(batch[k], dtype=torch.float32).to(device)
                                 for k in ("x", "r", "edges", "rscale"))
        params = state["params"]
        n = params["w1"].shape[0]  # this device's groups
        total = (lambda t: t) if sync is None else sync
        ids = grouping.assign_groups(xb, edges)
        xn, masks = _group_inputs(xb, ids, edges, g0, n)
        rscale = rscale[g0:g0 + n]
        safe = torch.where(rscale > 0, rscale, 1.0)
        target = rb[None] / safe[:, None, None, None] * masks
        with fp32_convs():  # forward and backward
            pred, new_bn = enhancer.apply(params, state["bn"], xn, train=True, mask=masks,
                                          sync=sync)
            se = (pred - target) ** 2 * masks
            losses = se.sum(dim=(1, 2, 3)) / torch.clamp(total(masks.sum(dim=(1, 2, 3))),
                                                         min=1.0)
            grads = dict(zip(params, torch.autograd.grad(losses.sum(), list(params.values()))))
        if sync is not None:  # this device's share of the losses and gradients
            losses = total(losses.detach())
            grads = {k: total(g) for k, g in grads.items()}
        if cfg.grad_compress:
            grads, state["ef"] = gc_apply(grads, state["ef"], gc_cfg)
        adamw.update(params, state["opt"], grads, cfg.lr, adam_cfg)
        with torch.no_grad():
            for k, v in new_bn.items():
                state["bn"][k].copy_(v)
        return state, losses.detach()

    if mesh is None:
        return lambda state, batch: local_step(state, batch, 0, None)

    from torch.distributed.tensor import DTensor, Replicate, Shard

    dims = [mesh.mesh_dim_names.index(a) for a in batch_axes_of(mesh)]
    model = mesh.mesh_dim_names.index("model")
    n_local = G // mesh.size(model)
    sync = lambda t: _SyncSum.apply(t, mesh, dims)  # noqa: E731

    def train_step(state: dict, batch: dict):
        local = tree.rebuild(state, lambda _, t: t.to_local() if isinstance(t, DTensor) else t)
        lbatch = {k: v.to_local() for k, v in batch.items()}
        g0 = mesh.get_local_rank(model) * n_local
        local, losses = local_step(local, lbatch, g0, sync)
        state["opt"]["step"] = local["opt"]["step"]
        if cfg.grad_compress:  # the new error feedback into the state's shards
            for path, e in tree.leaves(local["ef"]):
                tree.get(state["ef"], path).to_local().copy_(e)
        placements = [Shard(0) if i == model else Replicate() for i in range(mesh.ndim)]
        return state, DTensor.from_local(losses, mesh, placements, run_check=False)

    return train_step


def state_pspecs(cfg: DistGWLZConfig, state: dict):
    """Specs of a state tree: group-stacked leaves (leading [G]) on
    ``model``, the rest replicated."""

    def spec(_, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf  # the optimizer's integer step
        if leaf.ndim >= 1 and leaf.shape[0] == cfg.n_groups:
            return P("model", *([None] * (leaf.ndim - 1)))
        return P()

    return tree.rebuild(state, spec)


def batch_pspecs(mesh) -> dict:
    """Specs of a batch: slices on the batch axes, edges and scales
    replicated."""
    baxes = batch_axes_of(mesh)
    return {"x": P(baxes, None, None), "r": P(baxes, None, None), "edges": P(None),
            "rscale": P(None)}


def input_specs(cfg: DistGWLZConfig) -> dict:
    """Shape-only (``meta``) batch of the dry-run cell (a Nyx volume of
    ``cfg.volume``^3)."""
    V, B = cfg.volume, cfg.batch_slices
    meta = lambda *shape: torch.empty(shape, dtype=torch.float32, device="meta")  # noqa: E731
    return {"x": meta(B, V, V), "r": meta(B, V, V), "edges": meta(cfg.n_groups + 1),
            "rscale": meta(cfg.n_groups)}
