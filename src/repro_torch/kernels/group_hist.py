"""Launcher of the symbol histogram kernel (``csrc/symbol_hist.cu``;
replaces ``repro/kernels/group_hist.py::symbol_hist``).  Plain version:
``ref.symbol_hist_ref``.  The enhancer's ``group_hist`` is ported with the
enhancer."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p)


def symbol_hist(symbols: torch.Tensor, n_bins: int) -> torch.Tensor:
    """int32 CUDA tensor (any shape) -> int32 histogram [n_bins]; values
    outside [0, n_bins) are ignored."""
    if not symbols.is_cuda or symbols.dtype != torch.int32:
        raise ValueError(f"symbol_hist takes an int32 CUDA tensor, got "
                         f"{symbols.dtype} on {symbols.device}")
    if not 0 < n_bins < 2**31:
        raise ValueError(f"n_bins must be in [1, 2^31), got {n_bins}")
    flat = symbols.reshape(-1).contiguous()
    hist = torch.zeros(n_bins, dtype=torch.int32, device=symbols.device)
    if flat.numel() == 0:
        return hist
    with torch.cuda.device(symbols.device):
        _build.launch("symbol_hist", "symbol_hist", "symbol_hist", _ARGTYPES,
                      flat.data_ptr(), flat.numel(), n_bins, hist.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
    return hist
