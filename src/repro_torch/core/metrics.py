"""Compression-quality metrics (paper §2.1), port of ``repro/core/metrics.py``.

Each takes arrays or tensors and returns a 0-dim float32 tensor, computed in
float32 as the reference does."""
from __future__ import annotations

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def mse(x, y) -> torch.Tensor:
    return torch.mean((_f32(x) - _f32(y)) ** 2)


def vrange(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x.max() - x.min()


def psnr(x, y) -> torch.Tensor:
    """PSNR per Eq. (1): 20 log10 vrange(x) - 10 log10 mse(x, y)."""
    return (20.0 * torch.log10(vrange(_f32(x)))
            - 10.0 * torch.log10(torch.clamp(mse(x, y), min=1e-30)))


def nrmse(x, y) -> torch.Tensor:
    return torch.sqrt(mse(x, y)) / vrange(_f32(x))


def max_abs_err(x, y) -> torch.Tensor:
    return torch.max(torch.abs(torch.as_tensor(x) - torch.as_tensor(y)))
