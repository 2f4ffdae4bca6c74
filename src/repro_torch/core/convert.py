"""Carry enhancer weights across packages.

The reference keeps a GWLZ model as pytrees of JAX arrays with a leading
[G] axis; the port keeps the same layout in a
:class:`~repro_torch.core.enhancer.GroupEnhancers` module.  These functions
take the reference's leaves as numpy arrays (so nothing here imports JAX):
parity tests build both packages' models from the same numbers, and the
reference's random init is injected into the port's trainer through
``train_enhancers(..., params=...)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.enhancer import GroupEnhancers
from repro_torch.core.trainer import GWLZModel, GWLZTrainConfig
from repro_torch.kernels.ops import resolve_device


def enhancers_from_arrays(params: dict, bn_state: dict | None = None, *,
                          device=None) -> GroupEnhancers:
    """Reference params (``b1 b2 beta gamma w1 w2``, leading [G]) and
    optional BN state (``mean var``) -> the port's module on ``device``."""
    G, C = np.shape(params["b1"])
    return GroupEnhancers(G, C, device=resolve_device(device)).load(params, bn_state)


def model_from_arrays(params: dict, bn_state: dict, edges, rscale, *, device=None,
                      **cfg_fields) -> GWLZModel:
    """A reference ``GWLZModel``'s leaves and config fields -> the port's
    ``GWLZModel`` on ``device``."""
    device = resolve_device(device)
    enh = enhancers_from_arrays(params, bn_state, device=device)
    cfg = GWLZTrainConfig(**{"n_groups": enh.n_groups, "channels": enh.channels,
                             **cfg_fields})
    as_t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    return GWLZModel(enhancers=enh, edges=as_t(edges), rscale=as_t(rscale), cfg=cfg)
