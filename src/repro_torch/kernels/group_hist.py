"""Launchers of the two histogram kernels of ``repro/kernels/group_hist.py``:

* :func:`symbol_hist` (``csrc/symbol_hist.cu``; replaces ``symbol_hist``),
  plain version ``ref.symbol_hist_ref``;
* :func:`group_hist` (``csrc/group_hist.cu``; replaces ``group_hist``),
  plain version ``ref.group_hist_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p)
_GROUP_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
MAX_GROUPS = 4096  # csrc/group_hist.cu: edges + bins in 32 KB of shared memory


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


def group_hist(x: torch.Tensor, edges: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 CUDA tensor (any shape) and edges [G+1] -> (ids int32 of
    ``x``'s shape, hist int32 [G]); see ``ref.group_hist_ref``."""
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f"group_hist takes a float32 CUDA tensor, got {x.dtype} on "
                         f"{x.device}")
    if edges.ndim != 1 or edges.dtype != torch.float32 or edges.device != x.device:
        raise ValueError("group_hist takes float32 edges [G+1] on the values' device")
    G = edges.shape[0] - 1
    if not 1 <= G <= MAX_GROUPS:
        raise ValueError(f"group_hist takes 1..{MAX_GROUPS} groups, got {G}")
    flat = x.reshape(-1).contiguous()
    edges = edges.contiguous()
    ids = torch.empty(flat.shape, dtype=torch.int32, device=x.device)
    hist = torch.zeros(G, dtype=torch.int32, device=x.device)
    if flat.numel():
        with torch.cuda.device(x.device):
            _build.launch("group_hist", "group_hist", "group_hist", _GROUP_ARGTYPES,
                          flat.data_ptr(), flat.numel(), edges.data_ptr(), G,
                          ids.data_ptr(), hist.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    return ids.view(x.shape), hist
