"""Shared model building blocks: RMS norm and RoPE, port of
``repro/models/common.py`` (``:73-107``).

The reference's sharding helpers (``ShardingRules``, ``logical_shard``,
``shard_constraint``) are no-ops on one card and are not ported.
"""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with a zero-centred scale (``1 + scale``); the
    result in ``x``'s dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S].  Rotates the
    two halves of the head dimension, in float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # [D/2]
    ang = positions[..., None].to(torch.float32) * freqs  # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def normal_init(shape, scale: float, *, generator: torch.Generator, dtype) -> torch.Tensor:
    """``scale`` times a standard normal draw, in float32 on ``generator``'s
    device, cast to ``dtype`` (the reference's init; its ``jax.random``
    bits cannot be reproduced, so parity tests inject its draw).  The
    float32 draw, scaled in place, is the only transient."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
    return w.mul_(scale).to(dtype)
