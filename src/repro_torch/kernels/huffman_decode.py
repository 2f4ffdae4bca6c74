"""Launcher of the chunked multi-symbol-LUT Huffman decode
(``csrc/huffman_decode.cu``; replaces ``repro/kernels/huffman_decode.py::
huffman_decode_probe``).  Plain version: ``ref.huffman_decode_ref``.

The op takes the TPU kernel's split int32 tables (``lut_count``,
``lut_bits``, ``lut_ids`` [S, 2**k]).  The kernel reads the LUT as one
64-bit entry per window, the layout of the host codec's ``_multi_lut``:
count in bits 0-7, consumed bits in 8-15, then the S ids in B-bit slots from
bit 16 (or one 32-bit id from bit 32).  The codec hands its own packed LUT
to the launcher; :func:`pack_lut` builds it from split tables for callers
that have only those."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, ctypes.c_longlong, _P, _I, _P, ctypes.c_longlong, _P, _I, _I, _I,
             _P, _P, _P, _I, _I, _P, _P)
MAX_IDS = 8  # ids one probe may yield (the kernel's MAX_S)


def lut_layout(S: int) -> tuple[int, int]:
    """(B, id_base): bits per id slot and the first slot's bit offset of a
    packed entry holding S ids (the host's ``_multi_lut``: 6 x 8, 3 x 16 or
    1 x 32 bits)."""
    if not 1 <= S <= MAX_IDS:
        raise ValueError(f"a probe of {S} ids is outside 1..{MAX_IDS}")
    return (32, 32) if S == 1 else (48 // S, 16)


def pack_lut(lut_count: np.ndarray, lut_bits: np.ndarray, lut_ids: np.ndarray):
    """Split int32 tables (numpy) -> (packed uint64 [2**k], B, id_base).
    Refuses tables the packing cannot hold exactly: counts outside 0..S,
    consumed bits outside 0..255, ids outside B bits."""
    S = lut_ids.shape[0]
    B, id_base = lut_layout(S)
    cnt = lut_count.astype(np.int64)
    bits = lut_bits.astype(np.int64)
    ids = lut_ids.astype(np.int64)
    if cnt.size and (cnt.min() < 0 or cnt.max() > S or bits.min() < 0 or bits.max() > 255
                     or ids.min() < 0 or ids.max() >= 1 << B):
        raise ValueError("LUT tables outside the packed layout (counts 0..S, bits "
                         f"0..255, ids of {B} bits)")
    packed = cnt.astype(np.uint64) | (bits.astype(np.uint64) << np.uint64(8))
    for j in range(S):
        packed |= ids[j].astype(np.uint64) << np.uint64(id_base + j * B)
    return packed, B, id_base


def huffman_decode_probe(words, offsets, counts, lut_count, lut_bits, lut_ids,
                         cw_map, order, len_sorted, *, chunk_size: int, k: int,
                         lut: torch.Tensor | None = None) -> torch.Tensor:
    """words: [NW] int32 big-endian stream words; offsets: [C] int32 or int64
    bit offsets; counts: [C] int32; tables from ``HuffmanCodec._device_tables``
    (lut_ids is [S, 2**k]), all CUDA tensors on one device; ``lut``: the same
    LUT packed (int64 [2**k] on that device, as ``pack_lut`` packs it), or
    None to pack it here from the split tables.  Returns ids [C, chunk_size]
    int32."""
    named = dict(words=words, offsets=offsets, counts=counts, lut_count=lut_count,
                 lut_bits=lut_bits, lut_ids=lut_ids, cw_map=cw_map, order=order,
                 len_sorted=len_sorted)
    for name, t in named.items():
        ok = (torch.int32, torch.int64) if name == "offsets" else (torch.int32,)
        if not t.is_cuda or t.dtype not in ok or t.device != words.device:
            raise ValueError(f"huffman_decode_probe: {name} must be an "
                             f"{' or '.join(str(d)[6:] for d in ok)} tensor on "
                             f"{words.device}, got {t.dtype} on {t.device}")
    n = order.shape[0]
    if not 1 <= k <= 32 or lut_count.shape[0] != 1 << k or lut_ids.shape[1] != 1 << k:
        raise ValueError(f"LUT tables do not match k={k}")
    if n == 0 or cw_map.shape[0] != n or len_sorted.shape[0] != n or n >= 2**31 - 1:
        raise ValueError("codeword tables must be nonempty and of one length")
    C = offsets.shape[0]
    if counts.shape[0] != C or chunk_size < 1:
        raise ValueError("offsets/counts must be [C] and chunk_size positive")
    if C * chunk_size >= 2**62:
        raise ValueError(f"{C} chunks of {chunk_size} ids exceed the kernel's indexing")
    B, id_base = lut_layout(lut_ids.shape[0])
    if lut is None:
        packed, _, _ = pack_lut(*(t.cpu().numpy() for t in (lut_count, lut_bits, lut_ids)))
        lut = torch.from_numpy(packed.view(np.int64)).to(words.device)
    elif lut.dtype != torch.int64 or lut.shape != (1 << k,) or lut.device != words.device:
        raise ValueError(f"the packed LUT must be int64 [{1 << k}] on {words.device}")
    lut = lut.contiguous()
    words, offsets, counts = words.contiguous(), offsets.contiguous(), counts.contiguous()
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
