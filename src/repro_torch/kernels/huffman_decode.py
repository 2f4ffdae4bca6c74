"""Launcher of the chunked multi-symbol-LUT Huffman decode
(``csrc/huffman_decode.cu``; replaces ``repro/kernels/huffman_decode.py::
huffman_decode_probe``).  Plain version: ``ref.huffman_decode_ref``.

The decode reads its LUT as one 64-bit entry per k-bit window: the count of
whole codes in the window in bits 0-7 (0: escape to the binary search over
``cw_map``), the bits they consume in bits 8-15, then S ids of B bits from
bit ``id_base``.  :func:`lut_layout` is the rule that picks B, S and
``id_base`` from the alphabet size; the codec builds its LUT with it and the
launcher and the plain version read the entry with it."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, ctypes.c_longlong, _P, _I, _P, ctypes.c_longlong, _P, _I, _I, _I,
             _P, _P, _P, _I, _I, _P, _P)
_DTYPES = {"offsets": (torch.int32, torch.int64), "lut": (torch.int64,)}  # others: int32


def lut_layout(n_symbols: int) -> tuple[int, int, int]:
    """(B, S, id_base) of a LUT entry over an alphabet of ``n_symbols``:
    6 ids of 8 bits from bit 16 up to 256 symbols, 3 of 16 bits from bit 16
    up to 65,536, else one 32-bit id from bit 32."""
    B = 8 if n_symbols <= 256 else (16 if n_symbols <= 65536 else 32)
    id_base = 32 if B == 32 else 16
    return B, (64 - id_base) // B, id_base


def huffman_decode_probe(words, offsets, counts, lut, cw_map, order, len_sorted, *,
                         chunk_size: int, k: int) -> torch.Tensor:
    """words: [NW] int32 big-endian stream words; offsets: [C] int32 or int64
    bit offsets; counts: [C] int32; lut: int64 [2**k] packed entries
    (:func:`lut_layout`); cw_map, order, len_sorted: int32 [n]; all CUDA
    tensors on one device.  Returns ids [C, chunk_size] int32."""
    named = dict(words=words, offsets=offsets, counts=counts, lut=lut, cw_map=cw_map,
                 order=order, len_sorted=len_sorted)
    for name, t in named.items():
        ok = _DTYPES.get(name, (torch.int32,))
        if not t.is_cuda or t.dtype not in ok or t.device != words.device:
            raise ValueError(f"huffman_decode_probe: {name} must be an "
                             f"{' or '.join(str(d)[6:] for d in ok)} tensor on "
                             f"{words.device}, got {t.dtype} on {t.device}")
    n = order.shape[0]
    if not 1 <= k <= 32 or lut.shape != (1 << k,):
        raise ValueError(f"the LUT does not have 2**{k} entries")
    if n == 0 or cw_map.shape[0] != n or len_sorted.shape[0] != n or n >= 2**31 - 1:
        raise ValueError("codeword tables must be nonempty and of one length")
    C = offsets.shape[0]
    if counts.shape[0] != C or chunk_size < 1:
        raise ValueError("offsets/counts must be [C] and chunk_size positive")
    if C * chunk_size >= 2**62:
        raise ValueError(f"{C} chunks of {chunk_size} ids exceed the kernel's indexing")
    B, _, id_base = lut_layout(n)
    words, offsets, counts, lut = (t.contiguous() for t in (words, offsets, counts, lut))
    cw_map, order, len_sorted = cw_map.contiguous(), order.contiguous(), len_sorted.contiguous()
    out = torch.empty((C, chunk_size), dtype=torch.int32, device=words.device)
    if C == 0:
        return out
    with torch.cuda.device(words.device):
        _build.launch("huffman_decode", "huffman_decode", "huffman_decode_probe",
                      _ARGTYPES, words.data_ptr(), words.numel(), offsets.data_ptr(),
                      int(offsets.dtype == torch.int64), counts.data_ptr(), C,
                      lut.data_ptr(), k, B, id_base, cw_map.data_ptr(), order.data_ptr(),
                      len_sorted.data_ptr(), n, chunk_size, out.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
    return out
