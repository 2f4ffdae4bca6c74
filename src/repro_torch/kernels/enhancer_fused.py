"""Launcher of the group-wise fused enhancer kernel (``csrc/enhancer_fused.cu``;
replaces ``repro/kernels/enhancer_fused.py::enhancer_fused``).  Plain
version: ``ref.enhancer_grouped_ref``.

The G enhancers travel as one packed float32 table ``[G, 4 + 21C]`` (see
:func:`pack_enhancers`), which the kernel copies into shared memory; this
module owns that layout, and the plain version reads it from here."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p)
SMEM_BYTES = 227 * 1024  # an H100 block's shared memory
_WINDOW_BYTES = 2 * 36 * 36 * 4  # x and ids of a 32x32 block with its 2-cell halo

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
    smem = 4 * packed.numel() + _WINDOW_BYTES
    if smem > SMEM_BYTES:
        raise ValueError(f"{G} groups of {C} channels need {smem} B of shared memory; "
                         f"the kernel has {SMEM_BYTES}")
    B, H, W = x.shape
    if max(H, W) >= 2**31 or B * -(-H // 32) * -(-W // 32) >= 2**31:
        raise ValueError(f"slices {tuple(x.shape)} exceed the kernel's grid")
    x = x.contiguous()
    ids = None if ids is None else ids.contiguous()
    packed = packed.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        _build.launch("enhancer_fused", "enhancer_fused", "enhancer_grouped", _ARGTYPES,
                      x.data_ptr(), None if ids is None else ids.data_ptr(), B, H, W,
                      packed.data_ptr(), G, C, ENHANCE_MODES[mode],
                      int(clamp_eb is not None),
                      0.0 if clamp_eb is None else float(clamp_eb), out.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
    return out
