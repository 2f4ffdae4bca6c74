"""Launcher of the legacy-stream boundary pass (``csrc/huffman_legacy.cu``).

A legacy ``hf``/``hz`` Huffman stream has no chunk table; the reference
reads it with a host bit walk (``decode_bitwalk`` in
``repro/sz/entropy.py``), which has no Pallas kernel.  This kernel finds every
chunk's start bit by pointer doubling over the stream's bit positions, so
the chunked decode kernel can decode the chunks in parallel.  Plain
version: ``ref.huffman_legacy_bounds_ref``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = (_P, _L, _L, _L, _P, _P, _I, _P, _P, _P)


def _workspace_bytes(n_words: int, n_symbols: int, chunk_size: int) -> int:
    """The kernel's scratch size (its own layout, ``huffman_legacy_workspace``)."""
    f = _build._library("huffman_legacy").huffman_legacy_workspace
    f.argtypes = [_L, _L, _L]
    f.restype = _L
    return int(f(n_words, n_symbols, chunk_size))


def huffman_legacy_bounds(words, cw_map, len_sorted, *, n_symbols: int,
                          chunk_size: int) -> torch.Tensor:
    """words: [NW] int32 big-endian stream words (the stream starts at bit
    0); cw_map, len_sorted: int32 [n], the codec's decode tables, all CUDA
    tensors on one device; ``chunk_size`` a power of two.  Returns
    int64 [C + 1], C = ceil(n_symbols / chunk_size): the start bit of every
    chunk, then the bit after the last symbol."""
    for name, t in (("words", words), ("cw_map", cw_map), ("len_sorted", len_sorted)):
        if not t.is_cuda or t.dtype != torch.int32 or t.device != words.device:
            raise ValueError(f"huffman_legacy_bounds: {name} must be an int32 tensor on "
                             f"{words.device}, got {t.dtype} on {t.device}")
    n = cw_map.shape[0]
    if n == 0 or len_sorted.shape[0] != n or n >= 2**31 - 1:
        raise ValueError("codeword tables must be nonempty and of one length")
    if n_symbols < 0 or chunk_size < 1 or chunk_size & (chunk_size - 1):
        raise ValueError(f"n_symbols must be >= 0 and chunk_size a power of two, got "
                         f"{n_symbols} and {chunk_size}")
    if words.numel() == 0:
        raise ValueError("huffman_legacy_bounds: no stream words")
    C = -(-n_symbols // chunk_size)
    out = torch.zeros(C + 1, dtype=torch.int64, device=words.device)
    if n_symbols == 0:
        return out
    words, cw_map, len_sorted = words.contiguous(), cw_map.contiguous(), len_sorted.contiguous()
    with torch.cuda.device(words.device):
        work = torch.empty(_workspace_bytes(words.numel(), n_symbols, chunk_size),
                           dtype=torch.uint8, device=words.device)
        _build.launch("huffman_legacy", "huffman_legacy", "huffman_legacy_bounds", _ARGTYPES,
                      words.data_ptr(), words.numel(), n_symbols, chunk_size,
                      cw_map.data_ptr(), len_sorted.data_ptr(), n, work.data_ptr(),
                      out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    return out
