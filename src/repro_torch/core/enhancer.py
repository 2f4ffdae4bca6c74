"""The GWLZ learnable enhancer (paper Fig. 3), port of ``repro/core/enhancer.py``.

Encoder-decoder CNN: Conv3x3(1->C) -> BatchNorm -> ReLU -> Conv3x3(C->1),
C = 9 channels, ~190 trainable parameters + 2C running BN statistics.
Slices are single-channel images; the model predicts the normalised
residual map (DnCNN-style residual learning, §3.2).

The G enhancers of a volume live in one :class:`GroupEnhancers` module:
every parameter carries a leading ``[G]`` axis and the reference's layout
(w1 HWIO ``[G, 3, 3, 1, C]``, w2 ``[G, 3, 3, C, 1]``, b2 ``[G, 1]``), and
the forward runs all G models at once as grouped convolutions.  This is the
training path (autograd); inference on decoded data goes through the
group-wise kernel (``kernels.ops.enhancer_grouped_op``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ops import resolve_device

DEFAULT_CHANNELS = 9
PARAM_NAMES = ("b1", "b2", "beta", "gamma", "w1", "w2")  # sorted, as the blob stores them
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def init_params(n_groups: int, channels: int = DEFAULT_CHANNELS, *,
                generator: torch.Generator | None = None, device=None) -> dict:
    """He-normal conv weights, zero biases, unit BN scale: the reference's
    distribution (``jax.random`` bits cannot be reproduced; tests inject
    the reference's draw instead).  ``device=None`` means the CUDA device."""
    device = resolve_device(device)

    def normal(*shape, fan):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device="cpu")
        return (w * (2.0 / fan) ** 0.5).to(device)

    G, C = n_groups, channels
    return {
        "w1": normal(G, 3, 3, 1, C, fan=9),
        "b1": torch.zeros((G, C), device=device),
        "gamma": torch.ones((G, C), device=device),
        "beta": torch.zeros((G, C), device=device),
        "w2": normal(G, 3, 3, C, 1, fan=9 * C),
        "b2": torch.zeros((G, 1), device=device),
    }


def init_state(n_groups: int, channels: int = DEFAULT_CHANNELS, *, device=None) -> dict:
    """Non-trainable BN running statistics (stored in the model blob)."""
    device = resolve_device(device)
    return {"mean": torch.zeros((n_groups, channels), device=device),
            "var": torch.ones((n_groups, channels), device=device)}


@contextlib.contextmanager
def fp32_convs():
    """cuDNN runs float32 convolutions in TF32 unless told not to; the
    enhancer is trained against a float32 reference.  The backward runs
    when the gradient is taken, so a training step holds this around its
    ``autograd.grad`` as well."""
    cudnn = torch.backends.cudnn
    prev, cudnn.allow_tf32 = cudnn.allow_tf32, False
    try:
        yield
    finally:
        cudnn.allow_tf32 = prev


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """G grouped 3x3 SAME convolutions.  x [B, G*Cin, H, W]; w HWIO with a
    leading G axis [G, 3, 3, Cin, Cout]; b [G, Cout] -> [B, G*Cout, H, W].
    Same taps as the reference's shift-and-matmul (cross-correlation)."""
    G, _, _, cin, cout = w.shape
    weight = w.permute(0, 4, 3, 1, 2).reshape(G * cout, cin, 3, 3)
    with fp32_convs():
        return F.conv2d(x, weight, b.reshape(G * cout), padding=1, groups=G)


def hidden(params: dict, x: torch.Tensor) -> torch.Tensor:
    """conv1 of every group: x [G, B, H, W] -> h [B, G, C, H, W]."""
    G, B, H, W = x.shape
    h = _conv(x.transpose(0, 1), params["w1"], params["b1"])
    return h.view(B, G, -1, H, W)


def apply(params: dict, state: dict, x: torch.Tensor, *, train: bool,
          mask: torch.Tensor | None = None, sync=None) -> tuple[torch.Tensor, dict]:
    """Forward pass of all G models.

    ``x``: [G, B, H, W] normalised single-channel slices, one stack per
    group (zeros outside the group).  Returns ([G, B, H, W] predicted
    normalised residual, new BN state).  In train mode BN uses batch
    statistics over in-group pixels only (``mask`` [G, B, H, W]);
    ``sync`` (a device's slice of a batch split over devices) sums each
    per-group statistic over the devices, as synchronized BN does."""
    G, B, H, W = x.shape
    h = hidden(params, x)  # [B, G, C, H, W]
    if train:
        if mask is not None:
            total = (lambda t: t) if sync is None else sync
            m = mask.to(h.dtype).transpose(0, 1).unsqueeze(2)  # [B, G, 1, H, W]
            cnt = torch.clamp(total(m.sum(dim=(0, 3, 4))), min=1.0)
            mean = total((h * m).sum(dim=(0, 3, 4))) / cnt
            var = total(((h - mean[None, :, :, None, None]) ** 2 * m).sum(dim=(0, 3, 4))) / cnt
        else:
            mean = h.mean(dim=(0, 3, 4))
            var = h.var(dim=(0, 3, 4), unbiased=False)
        new_state = {
            "mean": (1 - BN_MOMENTUM) * state["mean"] + BN_MOMENTUM * mean.detach(),
            "var": (1 - BN_MOMENTUM) * state["var"] + BN_MOMENTUM * var.detach(),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    bcast = lambda t: t[None, :, :, None, None]
    h = (h - bcast(mean)) * torch.rsqrt(bcast(var) + BN_EPS) * bcast(params["gamma"]) \
        + bcast(params["beta"])
    h = torch.relu(h)
    out = _conv(h.reshape(B, -1, H, W), params["w2"], params["b2"])  # [B, G, H, W]
    return out.transpose(0, 1), new_state


class GroupEnhancers(nn.Module):
    """G enhancers as one module: parameters ``b1 b2 beta gamma w1 w2`` and
    BN buffers ``mean var``, each with a leading [G] axis, on ``device``
    (None: the CUDA device, which must exist).  The init draws from
    ``generator`` (default: seed 0), never from torch's global one."""

    def __init__(self, n_groups: int, channels: int = DEFAULT_CHANNELS, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.n_groups, self.channels = n_groups, channels
        generator = generator or torch.Generator().manual_seed(0)
        for name, value in init_params(n_groups, channels, generator=generator,
                                       device=device).items():
            self.register_parameter(name, nn.Parameter(value))
        for name, value in init_state(n_groups, channels, device=device).items():
            self.register_buffer(name, value)

    def params(self) -> dict:
        return {k: getattr(self, k) for k in PARAM_NAMES}

    def state(self) -> dict:
        return {"mean": self.mean, "var": self.var}

    def forward(self, x: torch.Tensor, *, train: bool = False,
                mask: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
        return apply(self.params(), self.state(), x, train=train, mask=mask)

    def load(self, params: dict, state: dict | None = None) -> "GroupEnhancers":
        """Copy arrays (numpy or tensors, reference layout) into the module."""
        def put(name, value):
            t = value if isinstance(value, torch.Tensor) else torch.from_numpy(
                np.array(value, np.float32))
            getattr(self, name).copy_(t.reshape(getattr(self, name).shape))

        with torch.no_grad():
            for k in PARAM_NAMES:
                put(k, params[k])
            for k, v in (state or {}).items():
                put(k, v)
        return self

    @property
    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
