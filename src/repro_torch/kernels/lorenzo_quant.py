"""Launchers of the fused prequantize + Lorenzo kernels
(``csrc/lorenzo_quant.cu``), which replace the two Pallas kernels of
``repro/kernels/lorenzo_quant.py``:

* :func:`lorenzo_quant_tiles` (per tile of a batch; replaces
  ``lorenzo_quant_tiles``), plain version ``ref.lorenzo_quant_tiles_ref``;
* :func:`lorenzo_quant` (one whole volume; replaces ``lorenzo_quant``),
  plain version ``ref.lorenzo_quant_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import two_eb_f32

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
_VOLUME_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
_SEG_Z = 32  # csrc/lorenzo_quant.cu: z-planes a warp marches


def _check_grid(B: int, Z: int, Y: int, X: int, what: str) -> None:
    """Refuse shapes past the kernel's grid: at most 2**31 - 1 blocks of four
    warps, a warp per 32 planes x 4 rows x 32 cells at the narrowest
    (csrc/lorenzo_quant.cu, VEC = 1)."""
    warps = B * -(-Z // _SEG_Z) * -(-Y // 4) * -(-X // 32)
    if max(Z, Y, X) >= 2**31 or -(-warps // 4) >= 2**31:
        raise ValueError(f"{what} exceeds the kernel's grid")


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
    _check_grid(x.shape[0], Z, Y, X, f"tile batch {tuple(x.shape)}")
    with torch.cuda.device(x.device):
        _build.launch("lorenzo_quant_tiles", "lorenzo_quant", "lorenzo_quant_tiles",
                      _ARGTYPES, x.data_ptr(), out.data_ptr(), x.shape[0], Z, Y, X,
                      two_eb_f32(eb), torch.cuda.current_stream().cuda_stream)
    return out


def lorenzo_quant(x: torch.Tensor, eb: float) -> torch.Tensor:
    """Float32 CUDA volume of rank 0..3 -> int32 Lorenzo codes of the whole
    volume (zero boundary at its faces).

    Ranks below 3 run as [1, 1, X] / [1, Y, X]; there is no kernel for
    rank 4 and above."""
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f"lorenzo_quant takes a float32 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    if x.ndim > 3:
        raise ValueError(f"the CUDA Lorenzo kernel takes volumes of rank 0..3, got {x.ndim}")
    x = x.contiguous()
    Z, Y, X = (1,) * (3 - x.ndim) + tuple(x.shape)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out
    _check_grid(1, Z, Y, X, f"volume {tuple(x.shape)}")
    with torch.cuda.device(x.device):
        _build.launch("lorenzo_quant", "lorenzo_quant", "lorenzo_quant_volume",
                      _VOLUME_ARGTYPES, x.data_ptr(), out.data_ptr(), Z, Y, X,
                      two_eb_f32(eb), torch.cuda.current_stream().cuda_stream)
    return out
