"""What an op needs, counted from the configuration and the shapes: bytes
moved, floating-point operations, and the least time an H100 takes for
them.  The same whatever implements the op, so a later change to the
program cannot move these counts.

The kernel bounds are frozen copies of the ones ``chip_smoke.py`` holds
the kernels to (its ``time_row`` byte and operation counts, and
``enhancer_flop``), but for the Huffman packing, which counts the words
the packed stream needs where ``chip_smoke.py`` counts a dense word
buffer, zeros included.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def least_s(nbytes: float, flop: float) -> float:
    """The least device time of the work: the larger of its bytes at the
    HBM rate and its operations at the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flop / FP32_OPS_PER_S)


# -- kernel bounds (frozen from chip_smoke.py) --------------------------------

def huffman_encode_bytes(n_chunks: int, chunk: int, stream_words: int) -> int:
    """Read the code lengths and codewords of every slot ([C, chunk] int32
    each); write the packed stream (``stream_words`` 32-bit words: each
    chunk's bits rounded up to a word) and the chunk bit counts."""
    return 8 * n_chunks * chunk + 4 * stream_words + 4 * n_chunks


def huffman_encode_ops(n_chunks: int, chunk: int) -> int:
    return 12 * n_chunks * chunk  # about twelve integer operations a symbol




def enhancer_fused_bytes(n: int, G: int, C: int) -> int:
    """Read values and group ids, write the output, plus the packed table."""
    return 12 * n + 4 * G * (4 + 21 * C)


def enhancer_flop(ids: torch.Tensor, live, C: int) -> int:
    """Operations the group-wise enhancer needs on slices whose groups are
    ``ids`` ([B, H, W]) when only the groups in ``live`` have an output, 2
    a fused multiply-add: a hidden value (9 taps x C channels) for every
    pixel q and group g that some pixel of q's 3x3 neighbourhood belongs
    to, and the 9C of conv2 for every output pixel of a live group."""
    n_h = n_out = 0
    for g in live:
        m = (ids == g)[:, None].to(torch.float32)
        n_out += int(torch.count_nonzero(m))
        n_h += int(torch.count_nonzero(F.max_pool2d(m, 3, stride=1, padding=1)))
        del m
    return 2 * 9 * C * (n_h + n_out)


# -- whole ops ----------------------------------------------------------------

def enhancer_forward_flop_per_value(C: int) -> int:
    """One pixel through its own group's enhancer: conv1 (9 x C) and conv2
    (9 x C) multiply-adds."""
    return 2 * 18 * C


def gwlz_write_flop(n_values: int, C: int, epochs: int) -> int:
    """A GWLZ compress: each value through its group's enhancer forward and
    backward (twice the forward) every epoch, then the BN calibration
    (conv1 once), the gate and the compress-time enhancement (a forward
    each)."""
    fwd = enhancer_forward_flop_per_value(C)
    conv1 = 2 * 9 * C
    return n_values * (3 * fwd * epochs + conv1 + 2 * fwd)


def write_bytes(n_values: int, container_bytes: int) -> int:
    """A compress reads the float32 field once and writes its container once."""
    return 4 * n_values + container_bytes


def read_bytes(n_values: int, container_bytes: int) -> int:
    """A decode reads the container once and writes the float32 values once."""
    return 4 * n_values + container_bytes
