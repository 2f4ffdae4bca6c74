"""Launcher of the group-wise fused enhancer kernel (``csrc/enhancer_fused.cu``;
replaces ``repro/kernels/enhancer_fused.py::enhancer_fused``).  Plain
version: ``ref.enhancer_grouped_ref``.

The G enhancers travel as one packed float32 table ``[G, 4 + 21C]`` (see
:func:`pack_enhancers`); this module owns that layout, and the plain
version reads it from here.  The kernel reads each group's weights as one
row of a transposed copy, :func:`kernel_table`, built for every launch."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p)
MAX_GROUPS = 4096  # as the group_hist kernel that assigns the groups


def _table_columns(C: int) -> list[int]:
    """Columns of a packed row that make a kernel-table row: lo, scale, b2,
    rscale, then per channel c: w1[0..8][c], b1[c], bn scale[c], bn
    shift[c], w2[0..8][c] and three pads (column 4 + 21C, a zero)."""
    cols = [0, 1, 2, 3]
    for c in range(C):
        cols += [4 + k * C + c for k in range(9)]
        cols += [4 + 9 * C + c, 4 + 10 * C + c, 4 + 11 * C + c]
        cols += [4 + 12 * C + k * C + c for k in range(9)]
        cols += [4 + 21 * C] * 3
    return cols


@functools.lru_cache(maxsize=16)
def _table_index(C: int, device: str) -> torch.Tensor:
    return torch.tensor(_table_columns(C), dtype=torch.int64, device=device)


def kernel_table(packed: torch.Tensor) -> torch.Tensor:
    """The packed enhancers [G, 4 + 21C] as the kernel reads them: [G,
    4 + 24C], each channel's 24 values contiguous (three 16-byte loads for
    conv1 and its BN, three for conv2)."""
    cols = _table_index(enhancer_channels(packed), str(packed.device))
    padded = torch.cat([packed, packed.new_zeros((packed.shape[0], 1))], dim=1)
    return padded.index_select(1, cols).contiguous()


BN_EPS = 1e-5
ENHANCE_MODES = {"pred": 0, "residual": 1, "direct": 2}


def fold_bn(gamma, beta, mean, var):
    """BN in inference form as one affine pair (scale, shift), folded as the
    TPU kernel folds it (``enhancer_fused.py:73-74``)."""
    inv = torch.rsqrt(var + BN_EPS) * gamma
    return inv, beta - mean * inv


def pack_enhancers(lo, scale, b2, rscale, w1, b1, bn_scale, bn_shift, w2) -> torch.Tensor:
    """G enhancers as one float32 table [G, 4 + 21C]: per group lo, scale,
    b2, rscale, w1 [9, C] (tap-major), b1 [C], bn_scale [C], bn_shift [C],
    w2 [9, C] (tap-major, channel-minor: the reference's [3, 3, C, 1])."""
    G = lo.shape[0]
    cols = [t.reshape(G, -1).to(torch.float32)
            for t in (lo, scale, b2, rscale, w1, b1, bn_scale, bn_shift, w2)]
    return torch.cat(cols, dim=1).contiguous()


def enhancer_channels(packed: torch.Tensor) -> int:
    C, rem = divmod(packed.shape[1] - 4, 21)
    if packed.ndim != 2 or C < 1 or rem:
        raise ValueError(f"packed enhancers must be [G, 4 + 21C], got {tuple(packed.shape)}")
    return C


def single_enhancer(w1, b1, gamma, beta, mean, var, w2, b2) -> torch.Tensor:
    """Pack one enhancer as the G = 1 table, with lo 0, scale 1, rscale 1."""
    C = w1.shape[-1]
    one = torch.ones(1, dtype=torch.float32, device=w1.device)
    bn_scale, bn_shift = fold_bn(gamma, beta, mean, var)
    return pack_enhancers(one * 0, one, b2.reshape(1), one, w1.reshape(1, 9, C),
                          b1.reshape(1, C), bn_scale.reshape(1, C), bn_shift.reshape(1, C),
                          w2.reshape(1, 9, C))


def enhancer_grouped(x: torch.Tensor, ids: torch.Tensor | None, packed: torch.Tensor, *,
                     mode: str, clamp_eb: float | None = None) -> torch.Tensor:
    """x [B, H, W] float32 and ids [B, H, W] int32 (None: all group 0) on a
    CUDA device, packed [G, 4 + 21C] -> [B, H, W] float32."""
    if not x.is_cuda or x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"enhancer_grouped takes float32 CUDA slices [B, H, W], got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if ids is not None and (ids.shape != x.shape or ids.dtype != torch.int32
                            or ids.device != x.device):
        raise ValueError("ids must be int32 of the slices' shape on their device")
    if mode not in ENHANCE_MODES:
        raise ValueError(f"unknown enhancer mode {mode!r}")
    if packed.dtype != torch.float32 or packed.device != x.device:
        raise ValueError("the packed enhancers must be float32 on the slices' device")
    G, C = packed.shape[0], enhancer_channels(packed)
    if G > MAX_GROUPS:
        raise ValueError(f"{G} groups exceed the kernel's {MAX_GROUPS}")
    B, H, W = x.shape
    if max(H, W) >= 2**31 or B * -(-H // 32) * -(-W // 32) >= 2**31:
        raise ValueError(f"slices {tuple(x.shape)} exceed the kernel's grid")
    x = x.contiguous()
    ids = None if ids is None else ids.contiguous()
    table = kernel_table(packed)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    # the count and list of blocks of many groups, which a second kernel runs
    many = torch.empty(1 + B * -(-H // 32) * -(-W // 32), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch("enhancer_fused", "enhancer_fused", "enhancer_grouped", _ARGTYPES,
                      x.data_ptr(), None if ids is None else ids.data_ptr(), B, H, W,
                      table.data_ptr(), G, C, ENHANCE_MODES[mode],
                      int(clamp_eb is not None),
                      0.0 if clamp_eb is None else float(clamp_eb), many.data_ptr(),
                      out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    return out
