"""Plain PyTorch versions of the four CUDA kernels.

Each function computes exactly what its kernel computes, on any device: the
dispatchers in ``kernels/ops.py`` run these for CPU tensors, and
``chip_smoke.py`` holds every kernel against them on the card.  They repeat
the kernels' arithmetic; they are no yardstick of speed.

Integer conventions: int32 arithmetic wraps modulo 2**32 here as in the
kernels (which compute in ``uint32_t``), and unsigned 32-bit words are
carried in int64 and masked where a shift could leave 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def two_eb_f32(eb: float) -> float:
    """The float32 grid pitch ``2 * float32(eb)`` (exact) as a Python float."""
    return float(np.float32(eb) * np.float32(2.0))


def two_eb_tensor(eb: float, device) -> torch.Tensor:
    """The grid pitch as a 0-dim float32 tensor on ``device``.  Dividing by a
    tensor keeps the division IEEE on CUDA, where ``div`` by a Python scalar
    multiplies by the reciprocal instead."""
    return torch.tensor(two_eb_f32(eb), dtype=torch.float32, device=device)


def _to_int32(w: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit value -> the int32 with those bits."""
    w = w & _M32
    return (w - ((w >> 31) << 32)).to(torch.int32)


def lorenzo_quant_tiles_ref(x: torch.Tensor, eb: float) -> torch.Tensor:
    """[B, *tile] float32 -> int32 Lorenzo codes, each tile its own domain.

    q = rint(x / 2eb) in float32, then a first difference along every tile
    axis with a zero boundary at the tile's leading edge.  The differences
    are int32 (as ``repro.kernels.ref.lorenzo_quant_ref``), not float32 as
    in the Pallas kernel, which parts from the oracle above |q| = 2**24."""
    q = torch.round(torch.div(x, two_eb_tensor(eb, x.device))).to(torch.int32)
    for ax in range(1, q.ndim):
        q = torch.diff(q, dim=ax, prepend=torch.zeros_like(q.narrow(ax, 0, 1)))
    return q


def symbol_hist_ref(symbols: torch.Tensor, n_bins: int) -> torch.Tensor:
    """int32 histogram [n_bins] of ``symbols``; values outside [0, n_bins)
    are ignored."""
    flat = symbols.reshape(-1).to(torch.int64)
    flat = torch.where((flat >= 0) & (flat < n_bins), flat, n_bins)
    return torch.bincount(flat, minlength=n_bins + 1)[:n_bins].to(torch.int32)


def huffman_encode_ref(lens: torch.Tensor, codes: torch.Tensor):
    """Chunk-parallel canonical-Huffman pack.

    lens/codes: [C, CS] int32 code lengths (1..32; 0 marks a pad slot) and
    canonical codewords.  Returns (words [C, CS] int32: each chunk's bits
    MSB-first across big-endian u32 words, zero past its end; chunk_bits
    [C] int32).  Bit ranges are disjoint, so a scatter-add equals the OR."""
    C, cs = lens.shape
    ln = lens.to(torch.int64)
    cw = codes.to(torch.int64) & _M32
    ends = torch.cumsum(ln, dim=1)
    starts = ends - ln
    aligned = torch.where(ln > 0, (cw << (32 - ln)) & _M32, 0)
    w0 = starts >> 5
    sh = starts & 31
    hi = aligned >> sh
    lo = (aligned << (32 - sh)) & _M32  # sh == 0 -> exactly 0
    words = torch.zeros((C, cs + 1), dtype=torch.int64, device=lens.device)
    words.scatter_add_(1, w0, hi)
    words.scatter_add_(1, w0 + 1, lo)
    return _to_int32(words[:, :cs]), ends[:, -1].to(torch.int32)


def huffman_decode_ref(words, offsets, counts, lut_count, lut_bits, lut_ids,
                       cw_map, order, len_sorted, *, chunk_size: int, k: int):
    """Multi-symbol LUT Huffman decode, all chunks in lockstep (the body of
    ``repro.kernels.huffman_decode._decode_block`` in torch).

    words: [NW] int32 big-endian stream words with >= 2 zero tail words;
    offsets/counts: [C] int32 bit offsets / symbol counts; tables from
    ``HuffmanCodec._device_tables``.  Returns ids [C, chunk_size] int32,
    zero past each chunk's count."""
    dev = words.device
    C = offsets.shape[0]
    S = lut_ids.shape[0]
    n = order.shape[0]
    w64 = words.to(torch.int64) & _M32
    last = w64.shape[0] - 1
    cw = cw_map.to(torch.int64)
    pos = offsets.to(torch.int64)
    target = counts.to(torch.int64)
    cur = torch.zeros(C, dtype=torch.int64, device=dev)
    out = torch.zeros(C * chunk_size, dtype=torch.int32, device=dev)
    base = torch.arange(C, dtype=torch.int64, device=dev) * chunk_size
    slots = torch.arange(S, dtype=torch.int64, device=dev)
    for _ in range(chunk_size):  # every probe yields >= 1 symbol
        active = cur < target
        if not bool(active.any()):
            break
        wi = pos >> 5
        sh = pos & 31
        h = w64[wi.clamp(max=last)]
        nxt = w64[(wi + 1).clamp(max=last)]
        w = ((h << sh) | (nxt >> (32 - sh))) & _M32
        idx = w >> (32 - k)
        cnt = lut_count[idx].to(torch.int64)
        nb = lut_bits[idx].to(torch.int64)
        ids = lut_ids[:, idx].T  # [C, S], a fresh tensor
        esc = cnt == 0
        if bool(esc.any()):
            # escape: binary search over the XOR-mapped codewords, with the
            # reference's mid <= n-1 clamp (huffman_decode.py:58-67)
            wm = w ^ 0x80000000
            wm = wm - ((wm >> 31) << 32)  # int32 value of the mapped window
            low = torch.zeros(C, dtype=torch.int64, device=dev)
            high = torch.full((C,), n, dtype=torch.int64, device=dev)
            for _ in range(max(n.bit_length(), 1)):
                mid = torch.clamp((low + high) >> 1, max=n - 1)
                go = cw[mid] <= wm
                low = torch.where(go, mid + 1, low)
                high = torch.where(go, high, mid)
            e_idx = (low - 1).clamp(min=0)
            cnt = torch.where(esc, 1, cnt)
            nb = torch.where(esc, len_sorted[e_idx].to(torch.int64), nb)
            ids[:, 0] = torch.where(esc, order[e_idx], ids[:, 0])
        take = torch.where(active, torch.minimum(cnt, target - cur), 0)
        hit = slots[None, :] < take[:, None]
        out[((base + cur)[:, None] + slots)[hit]] = ids[hit]
        pos = pos + torch.where(active, nb, 0)
        cur = cur + take
    return out.view(C, chunk_size)
