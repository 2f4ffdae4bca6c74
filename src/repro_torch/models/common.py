"""Shared model building blocks, port of ``repro/models/common.py``
(``:59-141``): ``shard_constraint``, RMS and layer norm, RoPE, Qwen2-VL's
multimodal RoPE (M-RoPE) and sinusoidal positions.

The reference's logical-axis helpers (``ShardingRules``,
``logical_shard``) have no caller in its models and are not ported.
"""
from __future__ import annotations

import torch


def shard_constraint(x: torch.Tensor, spec) -> torch.Tensor:
    """On a DTensor, ``x`` redistributed to ``spec``'s placements on its
    mesh (``launch.sharding.P``: a mesh axis, a tuple of them or None per
    dim).  A dim the named axes do not divide stays unsharded (XLA would
    pad it; a DTensor cannot view through an uneven shard).  On a plain
    tensor the identity, as the reference's constraint is outside a
    mesh."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.launch.sharding import P, axis_sizes, placements

    sizes = axis_sizes(x.device_mesh)

    def fits(d, s) -> bool:
        n = 1
        for a in (() if s is None else s if isinstance(s, tuple) else (s,)):
            n *= sizes[a]
        return x.shape[d] % n == 0

    spec = P(*(s if fits(d, s) else None for d, s in enumerate(spec)))
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with a zero-centred scale (``1 + scale``); the
    result in ``x``'s dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in float32 (population variance); the result in ``x``'s
    dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


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


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections: tuple[int, ...],
                theta: float = 1e6) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  x: [B, S, H, D]; positions3: [B, 3, S]
    (the t, h and w streams); ``sections`` are the half-dim sizes each
    stream rotates (e.g. (16, 24, 24)), in that order.  Half-dim f takes
    its angle from stream ``stream[f]``: the reference picks it with a
    one-hot product, which selects exactly, so an index does the same."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover half of head_dim {d}")
    freqs = rope_freqs(d, theta, x.device)  # [D/2]
    stream = torch.repeat_interleave(torch.arange(3, device=x.device),
                                     torch.tensor(sections, device=x.device), output_size=d // 2)
    pos = positions3.to(torch.float32).index_select(1, stream).transpose(1, 2)  # [B, S, D/2]
    ang = pos * freqs
    cos = torch.cos(ang)[..., None, :]  # [B, S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """[n, d] float32: sin at the even columns, cos at the odd ones, of
    position / 10000^(2i/d)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d))
    out = torch.zeros((n, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out


def normal_init(shape, scale: float, *, generator: torch.Generator, dtype) -> torch.Tensor:
    """``scale`` times a standard normal draw, in float32 on ``generator``'s
    device, cast to ``dtype`` (the reference's init; its ``jax.random``
    bits cannot be reproduced, so parity tests inject its draw).  The
    float32 draw, scaled in place, is the only transient."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
    return w.mul_(scale).to(dtype)
