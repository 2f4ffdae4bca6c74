"""Distributed GWLZ: the paper's group-wise enhancer training as one step
over a global slice batch, port of ``repro/launch/gwlz_dist.py``
(``:28-103``).

In the reference the step is an SPMD program: slices on the data axes,
the group axis on ``model`` (groups are independent, so no cross-group
collective exists), gradients optionally through the error-bounded int8
compression (``optim/grad_compress.py``).  On one card every sharding
collapses to the device, so :func:`make_dist_train_step` returns the step
alone, without the reference's sharding builders.

The step is not ``core/trainer.py::train_step``: it assigns groups inside
the step (``group_hist``, one launch a step), sums every group's loss with
no ``active`` weighting, uses the default ``AdamWConfig()`` at
``cfg.lr``, and compresses the gradients between the backward and the
AdamW update when ``cfg.grad_compress`` is set.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import enhancer, grouping
from repro_torch.core.enhancer import GroupEnhancers, fp32_convs
from repro_torch.core.trainer import _group_inputs
from repro_torch.kernels.ops import resolve_device
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


def make_dist_train_step(cfg: DistGWLZConfig, device=None):
    """Returns ``train_step(state, batch) -> (state, losses [G])``.  ``batch``
    is ``{"x": [B, H, W] decompressed slices, "r": [B, H, W] residuals,
    "edges": [G+1], "rscale": [G]}`` (tensors or arrays, moved to
    ``device``, None: the CUDA device).  The state's tensors are updated in
    place."""
    device = resolve_device(device)
    G = cfg.n_groups
    gc_cfg = GradCompressConfig(rel_eb=cfg.gc_rel_eb, enabled=cfg.grad_compress)
    adam_cfg = AdamWConfig()

    def train_step(state: dict, batch: dict):
        xb, rb, edges, rscale = (torch.as_tensor(batch[k], dtype=torch.float32).to(device)
                                 for k in ("x", "r", "edges", "rscale"))
        ids = grouping.assign_groups(xb, edges)
        xn, masks = _group_inputs(xb, ids, edges, G)
        safe = torch.where(rscale > 0, rscale, 1.0)
        target = rb[None] / safe[:, None, None, None] * masks
        params = state["params"]
        with fp32_convs():  # forward and backward
            pred, new_bn = enhancer.apply(params, state["bn"], xn, train=True, mask=masks)
            se = (pred - target) ** 2 * masks
            losses = se.sum(dim=(1, 2, 3)) / torch.clamp(masks.sum(dim=(1, 2, 3)), min=1.0)
            grads = dict(zip(params, torch.autograd.grad(losses.sum(), list(params.values()))))
        if cfg.grad_compress:
            grads, state["ef"] = gc_apply(grads, state["ef"], gc_cfg)
        adamw.update(params, state["opt"], grads, cfg.lr, adam_cfg)
        with torch.no_grad():
            for k, v in new_bn.items():
                state["bn"][k].copy_(v)
        return state, losses.detach()

    return train_step
