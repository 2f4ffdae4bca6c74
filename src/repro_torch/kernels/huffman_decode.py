"""Launcher of the chunked multi-symbol-LUT Huffman decode
(``csrc/huffman_decode.cu``; replaces ``repro/kernels/huffman_decode.py::
huffman_decode_probe``).  Plain version: ``ref.huffman_decode_ref``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_ARGTYPES = (_P, ctypes.c_longlong, _P, _P, ctypes.c_longlong, _P, _P, _P,
             ctypes.c_int, ctypes.c_int, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P)


def huffman_decode_probe(words, offsets, counts, lut_count, lut_bits, lut_ids,
                         cw_map, order, len_sorted, *, chunk_size: int,
                         k: int) -> torch.Tensor:
    """words: [NW] int32 big-endian stream words; offsets/counts: [C] int32;
    tables from ``HuffmanCodec._device_tables`` (lut_ids is [S, 2**k]), all
    int32 CUDA tensors on one device.  Returns ids [C, chunk_size] int32."""
    named = dict(words=words, offsets=offsets, counts=counts, lut_count=lut_count,
                 lut_bits=lut_bits, lut_ids=lut_ids, cw_map=cw_map, order=order,
                 len_sorted=len_sorted)
    for name, t in named.items():
        if not t.is_cuda or t.dtype != torch.int32 or t.device != words.device:
            raise ValueError(f"huffman_decode_probe: {name} must be an int32 tensor on "
                             f"{words.device}, got {t.dtype} on {t.device}")
    n = order.shape[0]
    if not 1 <= k <= 32 or lut_count.shape[0] != 1 << k or lut_ids.shape[1] != 1 << k:
        raise ValueError(f"LUT tables do not match k={k}")
    if n == 0 or cw_map.shape[0] != n or len_sorted.shape[0] != n:
        raise ValueError("codeword tables must be nonempty and of one length")
    C = offsets.shape[0]
    if counts.shape[0] != C or chunk_size < 1:
        raise ValueError("offsets/counts must be [C] and chunk_size positive")
    words, offsets, counts = words.contiguous(), offsets.contiguous(), counts.contiguous()
    lut_ids = lut_ids.contiguous()
    out = torch.empty((C, chunk_size), dtype=torch.int32, device=words.device)
    if C == 0:
        return out
    with torch.cuda.device(words.device):
        _build.launch("huffman_decode", "huffman_decode", "huffman_decode_probe",
                      _ARGTYPES, words.data_ptr(), words.numel(), offsets.data_ptr(),
                      counts.data_ptr(), C, lut_count.data_ptr(), lut_bits.data_ptr(),
                      lut_ids.data_ptr(), lut_ids.shape[0], k, cw_map.data_ptr(),
                      order.data_ptr(), len_sorted.data_ptr(), n, chunk_size,
                      out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    return out
