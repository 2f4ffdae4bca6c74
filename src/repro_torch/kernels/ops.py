"""Dispatch layer: each op runs its CUDA kernel on CUDA tensors and its plain
PyTorch version (``kernels/ref.py``) on CPU tensors.

The choice follows the tensor's device and nothing else: there is no flag,
and a kernel that fails to build or launch raises -- nothing falls back.
``LAUNCHES`` counts successful kernel launches per op (plain-version calls
are not counted); ``reset_launches()`` zeroes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.group_hist import symbol_hist
from repro_torch.kernels.huffman_decode import huffman_decode_probe
from repro_torch.kernels.huffman_encode import huffman_encode_pack
from repro_torch.kernels.lorenzo_quant import lorenzo_quant_tiles

LAUNCHES = _build.LAUNCHES
reset_launches = _build.reset_launches


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device, which must exist: the port never
    carries on on the CPU unless the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run "
                               "the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return False


def lorenzo_quant_tiles_op(x: torch.Tensor, eb: float) -> torch.Tensor:
    """[B, *tile] float32 -> int32 per-tile Lorenzo codes of rint(x / 2eb)."""
    if _on_cuda(x):
        return lorenzo_quant_tiles(x, eb)
    return ref.lorenzo_quant_tiles_ref(x, eb)


def lorenzo_decode_tiles_op(codes: torch.Tensor, eb: float) -> torch.Tensor:
    """Exact inverse of :func:`lorenzo_quant_tiles_op`: an int32 cumsum along
    every tile axis (``dtype=torch.int32``, so it wraps mod 2**32 as the
    reference's does), then dequantize.  No kernel: plain torch on every
    device, elementwise-exact in the batch axis."""
    from repro_torch.sz.quantizer import dequantize_pre

    q = codes
    for ax in range(1, q.ndim):
        q = torch.cumsum(q, dim=ax, dtype=torch.int32)
    return dequantize_pre(q, eb)


def symbol_hist_op(symbols: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """int32 histogram [n_bins] of an int32 tensor; values outside
    [0, n_bins) are ignored."""
    if _on_cuda(symbols):
        return symbol_hist(symbols, n_bins)
    return ref.symbol_hist_ref(symbols, n_bins)


def huffman_encode_op(lens: torch.Tensor, codes: torch.Tensor):
    """[C, CS] int32 code lengths / codewords -> (words [C, CS] int32,
    chunk_bits [C] int32)."""
    if _on_cuda(lens):
        return huffman_encode_pack(lens, codes)
    return ref.huffman_encode_ref(lens, codes)


def huffman_decode_op(words, offsets, counts, lut_count, lut_bits, lut_ids,
                      cw_map, order, len_sorted, *, chunk_size: int,
                      k: int) -> torch.Tensor:
    """Multi-symbol-LUT Huffman decode -> alphabet ids [C, chunk_size] int32
    (words need >= 2 zero tail words)."""
    args = (words, offsets, counts, lut_count, lut_bits, lut_ids, cw_map, order,
            len_sorted)
    if _on_cuda(words):
        return huffman_decode_probe(*args, chunk_size=chunk_size, k=k)
    return ref.huffman_decode_ref(*args, chunk_size=chunk_size, k=k)
