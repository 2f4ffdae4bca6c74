"""Launcher of the chunk-parallel Huffman encode pack
(``csrc/huffman_encode.cu``; replaces ``repro/kernels/huffman_encode.py::
huffman_encode_pack``).  Plain version: ``ref.huffman_encode_ref``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# one chunk's words live in shared memory: 48 KB without opting in to more
MAX_CHUNK = 48 * 1024 // 4

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def huffman_encode_pack(lens: torch.Tensor, codes: torch.Tensor):
    """lens/codes: [C, CS] int32 CUDA tensors (lengths 1..32, 0 = pad slot)
    -> (words [C, CS] int32, chunk_bits [C] int32)."""
    if lens.shape != codes.shape or lens.ndim != 2:
        raise ValueError(f"lens {tuple(lens.shape)} / codes {tuple(codes.shape)} "
                         "must both be [C, CS]")
    for t in (lens, codes):
        if not t.is_cuda or t.dtype != torch.int32:
            raise ValueError(f"huffman_encode_pack takes int32 CUDA tensors, got "
                             f"{t.dtype} on {t.device}")
    C, cs = lens.shape
    if not 0 < cs <= MAX_CHUNK:
        raise ValueError(f"chunk size {cs} outside the kernel's 1..{MAX_CHUNK}")
    lens, codes = lens.contiguous(), codes.contiguous()
    words = torch.empty((C, cs), dtype=torch.int32, device=lens.device)
    chunk_bits = torch.empty(C, dtype=torch.int32, device=lens.device)
    if C == 0:
        return words, chunk_bits
    with torch.cuda.device(lens.device):
        _build.launch("huffman_encode", "huffman_encode", "huffman_encode_pack",
                      _ARGTYPES, lens.data_ptr(), codes.data_ptr(), C, cs,
                      words.data_ptr(), chunk_bits.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
    return words, chunk_bits
