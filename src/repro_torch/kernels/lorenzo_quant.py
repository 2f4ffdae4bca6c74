"""Launcher of the fused prequantize + per-tile Lorenzo kernel
(``csrc/lorenzo_quant.cu``; replaces ``repro/kernels/lorenzo_quant.py::
lorenzo_quant_tiles``).  Plain version: ``ref.lorenzo_quant_tiles_ref``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import two_eb_f32

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)


def lorenzo_quant_tiles(x: torch.Tensor, eb: float) -> torch.Tensor:
    """[B, *tile] float32 CUDA tensor, tile rank 1..3 -> int32 codes.

    Rank-1 and rank-2 tiles run as [B, 1, 1, X] / [B, 1, Y, X]: a difference
    along a size-1 axis is the identity."""
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f"lorenzo_quant_tiles takes a float32 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    if not 2 <= x.ndim <= 4:
        raise ValueError(f"the CUDA Lorenzo kernel takes tiles of rank 1..3, got "
                         f"{x.ndim - 1}")
    x = x.contiguous()
    Z, Y, X = (1,) * (4 - x.ndim) + tuple(x.shape[1:])
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out
    if max(Z, Y, X) >= 2**31 or x.shape[0] * -(-X // 32) * -(-Y // 8) >= 2**31:
        raise ValueError(f"tile batch {tuple(x.shape)} exceeds the kernel's grid")
    with torch.cuda.device(x.device):
        _build.launch("lorenzo_quant_tiles", "lorenzo_quant", "lorenzo_quant_tiles",
                      _ARGTYPES, x.data_ptr(), out.data_ptr(), x.shape[0], Z, Y, X,
                      two_eb_f32(eb), torch.cuda.current_stream().cuda_stream)
    return out
