"""Plain GWLZ enhancement of decoded tiles, in torch with TF32 off.

The model blob (``GWLZ`` magic; G groups, C channels, strategy, residual
flag; then each leaf as a u32 count and float32 values: b1 b2 beta gamma w1
w2, BN mean and var, the G + 1 group edges, the G residual scales) is read
from the container's ``gwlz`` extra.  Each tile is cut into slices along
its first axis; a value's group is the number of the first G edges at or
below it, less one, clipped to [0, G); group ``g``'s model sees the slice
normalised by that group's (lo, width) with the pixels of other groups set
to 0, and runs conv3x3 (1 -> C, zero padding) -> BatchNorm (running
statistics) -> ReLU -> conv3x3 (C -> 1).  An enhanced value is
``x + pred * rscale[g]`` for the pixels of group ``g`` (``x`` where
``rscale[g]`` is 0).
"""
from __future__ import annotations

import struct

import numpy as np
import torch
import torch.nn.functional as F

_HEAD = struct.Struct("<4sIIIB3x")
BN_EPS = 1e-5


def parse_model(blob: bytes) -> dict:
    magic, G, C, _strategy, residual = _HEAD.unpack_from(blob, 0)
    if magic != b"GWLZ":
        raise ValueError("bad GWLZ model blob")
    shapes = [("b1", (G, C)), ("b2", (G, 1)), ("beta", (G, C)), ("gamma", (G, C)),
              ("w1", (G, 3, 3, 1, C)), ("w2", (G, 3, 3, C, 1)), ("mean", (G, C)),
              ("var", (G, C)), ("edges", (G + 1,)), ("rscale", (G,))]
    off = _HEAD.size
    leaves = {"G": G, "C": C, "residual": bool(residual)}
    for name, shape in shapes:
        (n,) = struct.unpack_from("<I", blob, off)
        if n != int(np.prod(shape)):
            raise ValueError(f"model leaf {name} has {n} values")
        leaves[name] = np.frombuffer(blob, np.float32, n, offset=off + 4).reshape(shape).copy()
        off += 4 + 4 * n
    return leaves


def group_ids(xs: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    G = edges.numel() - 1
    ids = torch.searchsorted(edges[:G].contiguous(), xs.contiguous(), right=True) - 1
    return ids.clamp_(0, G - 1)


def enhance_slices(xs: torch.Tensor, model: dict, *, dtype=torch.float32,
                   chunk: int = 2048) -> torch.Tensor:
    """Enhanced slices [B, H, W] (float32 in and out; arithmetic in ``dtype``)."""
    if not model["residual"]:
        raise ValueError("the reference enhances residual-learning models only")
    dev = xs.device
    t = {k: torch.from_numpy(v).to(dev, dtype) for k, v in model.items()
         if isinstance(v, np.ndarray)}
    G, C = model["G"], model["C"]
    edges32 = torch.from_numpy(model["edges"]).to(dev)
    lo = t["edges"][:-1]
    width = torch.clamp(t["edges"][1:] - t["edges"][:-1], min=1e-12)
    w1 = t["w1"].permute(0, 4, 3, 1, 2)  # [G, C, 1, 3, 3]
    w2 = t["w2"].permute(0, 4, 3, 1, 2)  # [G, 1, C, 3, 3]
    inv = torch.rsqrt(t["var"] + BN_EPS)
    out = torch.empty_like(xs)
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(0, xs.shape[0], chunk):
            x32 = xs[i:i + chunk]
            ids = group_ids(x32, edges32)
            x = x32.to(dtype)
            res = x.clone()
            for g in range(G):
                if float(model["rscale"][g]) == 0.0:
                    continue
                m = ids == g
                if not bool(m.any()):
                    continue
                xin = torch.where(m, (x - lo[g]) / width[g], 0.0)[:, None]
                h = F.conv2d(xin, w1[g], t["b1"][g], padding=1)
                h = (h - t["mean"][g][None, :, None, None]) * inv[g][None, :, None, None]
                h = torch.relu(h * t["gamma"][g][None, :, None, None]
                               + t["beta"][g][None, :, None, None])
                pred = F.conv2d(h, w2[g], t["b2"][g], padding=1)[:, 0]
                res = torch.where(m, x + pred * t["rscale"][g], res)
            out[i:i + chunk] = res.to(torch.float32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def enhance_tiles(tiles: torch.Tensor, model: dict, *, dtype=torch.float32) -> torch.Tensor:
    """Tiles [K, T0, T1, T2] -> enhanced tiles, sliced along each tile's axis 0."""
    k, t0, t1, t2 = tiles.shape
    return enhance_slices(tiles.reshape(k * t0, t1, t2), model, dtype=dtype).view(tiles.shape)
