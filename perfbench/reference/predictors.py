"""Plain inverse predictors of the tiled container, in torch, and the codes
each predictor would write for a given input.

* Lorenzo: a tile's codes are the first differences, along every axis with
  a zero boundary, of ``q = rint(x / 2eb)``; the decode is an int32 running
  sum along each axis, then ``float32(q) * 2eb``.
* Interp (SZ3-style): each tile is edge-padded to ``M * 2**levels + 1`` a
  side; the stride-``2**levels`` grid is Lorenzo-coded; each level (stride
  S/2 ... 1) then predicts, axis after axis, the points at odd multiples of
  the stride from the points already known (linear ``(a + b) * 0.5`` or the
  four-point cubic ``((-a + 9b) + 9c - d) / 16`` with linear ends) and
  adds ``code * 2eb``; an outlier is stored verbatim.

``2eb`` is the float32 value of the bound doubled; every arithmetic step is
its own float32 operation.  Given the input, :func:`decode_tiles` also
counts the codes that disagree with the ones the predictor derives from
that input: Lorenzo's from ``x`` alone, interp's from ``x`` and the
prediction of the points decoded so far, where the value is no outlier.
"""
from __future__ import annotations

import math

import numpy as np
import torch

OUTLIER_RADIUS = 1 << 15


def two_eb(eb: float, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(float(np.float32(eb) * np.float32(2.0)), dtype=dtype, device=device)


def pad_edge(x: torch.Tensor, shape, first_axis: int = 0) -> torch.Tensor:
    """Edge replication up to ``shape`` on the axes from ``first_axis`` on."""
    for ax, p in enumerate(shape, start=first_axis):
        d = x.shape[ax]
        if p > d:
            idx = torch.arange(p, device=x.device).clamp_(max=d - 1)
            x = x.index_select(ax, idx)
    return x


def split_tiles(x: torch.Tensor, tile) -> torch.Tensor:
    """Volume -> edge-padded tiles [n, *tile] in row-major grid order."""
    grid = [-(-d // t) for d, t in zip(x.shape, tile)]
    x = pad_edge(x, [g * t for g, t in zip(grid, tile)])
    g0, g1, g2 = grid
    t0, t1, t2 = tile
    return x.reshape(g0, t0, g1, t1, g2, t2).permute(0, 2, 4, 1, 3, 5).reshape(-1, t0, t1, t2)


def stitch_tiles(tiles: torch.Tensor, shape, tile) -> torch.Tensor:
    grid = [-(-d // t) for d, t in zip(shape, tile)]
    g0, g1, g2 = grid
    t0, t1, t2 = tile
    vol = tiles.reshape(g0, g1, g2, t0, t1, t2).permute(0, 3, 1, 4, 2, 5)
    vol = vol.reshape(g0 * t0, g1 * t1, g2 * t2)
    return vol[: shape[0], : shape[1], : shape[2]]


def lorenzo_codes(x: torch.Tensor, eb: float) -> torch.Tensor:
    """Codes of a batch [B, ...] of Lorenzo domains."""
    q = torch.round(x / two_eb(eb, x.device)).to(torch.int32)
    for ax in range(1, q.ndim):
        q = torch.diff(q, dim=ax, prepend=torch.zeros_like(q.narrow(ax, 0, 1)))
    return q


def lorenzo_decode(codes: torch.Tensor, eb: float, dtype=torch.float32) -> torch.Tensor:
    q = codes
    for ax in range(1, q.ndim):
        q = torch.cumsum(q, dim=ax, dtype=torch.int32)
    return q.to(dtype) * two_eb(eb, q.device, dtype)


def interp_padded(tile, levels: int):
    s = 1 << levels
    return tuple(((max(d - 1, 1) + s - 1) // s) * s + 1 for d in tile)


def _predict(e: torch.Tensor, axis: int, order: str) -> torch.Tensor:
    n = e.shape[axis]
    a, b = e.narrow(axis, 0, n - 1), e.narrow(axis, 1, n - 1)
    lin = (a + b) * 0.5
    if order == "linear" or n < 4:
        return lin
    e0, e1 = e.narrow(axis, 0, n - 3), e.narrow(axis, 1, n - 3)
    e2, e3 = e.narrow(axis, 2, n - 3), e.narrow(axis, 3, n - 3)
    cub = (((-e0) + e1 * 9.0) + e2 * 9.0 - e3) / 16.0
    return torch.cat([lin.narrow(axis, 0, 1), cub, lin.narrow(axis, n - 2, 1)], dim=axis)


def _sweeps(levels: int):
    """(axis, target slices, known slices) over a batch [B, p0, p1, p2]."""
    for lv in range(levels, 0, -1):
        s = 1 << (lv - 1)
        known = [slice(0, None, 2 * s)] * 3
        for axis in range(3):
            tgt, src = list(known), list(known)
            tgt[axis] = slice(s, None, 2 * s)
            yield axis + 1, (slice(None), *tgt), (slice(None), *src)
            known[axis] = slice(0, None, s)


def interp_decode(codes, omask, ovals, eb: float, levels: int, order: str, *,
                  x=None, dtype=torch.float32):
    """Decode a batch of interp-padded tiles; with ``x`` (the padded input,
    same shape) also count codes that differ from the derived ones.
    Returns (recon, code mismatches)."""
    dev = codes.device
    pitch = two_eb(eb, dev, dtype)
    coarse = (slice(None),) + (slice(0, None, 1 << levels),) * 3
    recon = torch.zeros(codes.shape, dtype=dtype, device=dev)
    recon[coarse] = lorenzo_decode(codes[coarse].contiguous(), eb, dtype)
    bad = 0
    if x is not None:
        bad += int((lorenzo_codes(x[coarse].contiguous(), eb) != codes[coarse]).sum())
    for axis, tgt, src in _sweeps(levels):
        pred = _predict(recon[src], axis, order)
        code = codes[tgt]
        rec = pred + code.to(dtype) * pitch
        out = omask[tgt]
        recon[tgt] = torch.where(out, ovals[tgt].to(dtype), rec)
        if x is not None:
            want = torch.round((x[tgt] - pred) / pitch)
            want = torch.where(want.abs() >= OUTLIER_RADIUS, 0.0, want).to(torch.int32)
            bad += int(((want != code) & ~out).sum())
    return recon, bad


def scatter_outliers(idx: np.ndarray, val: np.ndarray, shape, device):
    n = math.prod(shape)
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    vals = torch.zeros(n, dtype=torch.float32, device=device)
    if idx.size:
        i = torch.from_numpy(idx.astype(np.int64)).to(device)
        mask[i] = True
        vals[i] = torch.from_numpy(val.astype(np.float32)).to(device)
    return mask.view(shape), vals.view(shape)
