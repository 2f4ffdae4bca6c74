"""Plain PyTorch versions of the CUDA kernels.

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
import torch.nn.functional as F

from repro_torch.kernels.enhancer_fused import (  # the kernel owns its table layout
    enhancer_channels,
    single_enhancer,
)
from repro_torch.kernels.huffman_decode import lut_layout

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


def _quant_diff(x: torch.Tensor, eb: float, first_axis: int) -> torch.Tensor:
    q = torch.round(torch.div(x, two_eb_tensor(eb, x.device))).to(torch.int32)
    for ax in range(first_axis, q.ndim):
        q = torch.diff(q, dim=ax, prepend=torch.zeros_like(q.narrow(ax, 0, 1)))
    return q


def lorenzo_quant_ref(x: torch.Tensor, eb: float) -> torch.Tensor:
    """Float32 volume (any rank) -> int32 Lorenzo codes of the whole volume:
    q = rint(x / 2eb) in float32, then a first difference along every axis
    with a zero boundary at the leading face, in int32 (wrapping), as
    ``repro.kernels.ref.lorenzo_quant_ref``."""
    return _quant_diff(x, eb, 0)


def lorenzo_quant_tiles_ref(x: torch.Tensor, eb: float) -> torch.Tensor:
    """[B, *tile] float32 -> int32 Lorenzo codes, each tile its own domain:
    :func:`lorenzo_quant_ref` of every tile.  The differences are int32 (as
    ``repro.kernels.ref.lorenzo_quant_ref``), not float32 as in the Pallas
    kernel, which parts from the oracle above |q| = 2**24."""
    return _quant_diff(x, eb, 1)


def symbol_hist_lanes_ref(codes: torch.Tensor, lo: torch.Tensor | None,
                          n_bins: int) -> torch.Tensor:
    """int32 histograms [L, n_bins] of the rows of codes [L, n]: row l counts
    ``codes[l] - lo[l]`` (lo [L], None: 0; the difference exact, in int64)
    inside [0, n_bins); other values are ignored."""
    L = codes.shape[0]
    d = codes.reshape(L, -1).to(torch.int64)
    if lo is not None:
        d = d - lo.to(torch.int64)[:, None]
    d = torch.where((d >= 0) & (d < n_bins), d, n_bins)  # out of range -> a dropped bin
    d = d + (n_bins + 1) * torch.arange(L, dtype=torch.int64, device=codes.device)[:, None]
    hist = torch.bincount(d.reshape(-1), minlength=L * (n_bins + 1))
    return hist.view(L, n_bins + 1)[:, :n_bins].to(torch.int32)


def symbol_hist_ref(symbols: torch.Tensor, n_bins: int) -> torch.Tensor:
    """int32 histogram [n_bins] of ``symbols``; values outside [0, n_bins)
    are ignored: the one-row case of :func:`symbol_hist_lanes_ref`."""
    return symbol_hist_lanes_ref(symbols.reshape(1, -1), None, n_bins)[0]


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


def huffman_decode_ref(words, offsets, counts, lut, cw_map, order, len_sorted, *,
                       chunk_size: int, k: int):
    """Multi-symbol LUT Huffman decode, all chunks in lockstep (the body of
    ``repro.kernels.huffman_decode._decode_block`` in torch).

    words: [NW] int32 big-endian stream words with >= 2 zero tail words;
    offsets: [C] int32 or int64 bit offsets (walked in int64, so a stream
    may run past 2**32 bits); counts: [C] int32 symbol counts; lut: int64
    [2**k] packed entries, read with the kernel's shifts
    (``huffman_decode.lut_layout``); cw_map, order, len_sorted: int32 [n].
    Returns ids [C, chunk_size] int32, zero past each chunk's count."""
    dev = words.device
    C = offsets.shape[0]
    n = order.shape[0]
    B, S, id_base = lut_layout(n)
    w64 = words.to(torch.int64) & _M32
    last = w64.shape[0] - 1
    cw = cw_map.to(torch.int64)
    pos = offsets.to(torch.int64)
    target = counts.to(torch.int64)
    cur = torch.zeros(C, dtype=torch.int64, device=dev)
    out = torch.zeros(C * chunk_size, dtype=torch.int32, device=dev)
    base = torch.arange(C, dtype=torch.int64, device=dev) * chunk_size
    slots = torch.arange(S, dtype=torch.int64, device=dev)
    shifts = id_base + B * slots
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
        e = lut[idx]
        cnt = e & 0xFF
        nb = (e >> 8) & 0xFF
        ids = ((e[:, None] >> shifts) & ((1 << B) - 1)).to(torch.int32)  # [C, S]
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


def huffman_legacy_bounds_ref(words, cw_map, len_sorted, *, n_symbols: int,
                              chunk_size: int) -> torch.Tensor:
    """Chunk start bits of a legacy (chunk-table-free) Huffman stream that
    starts at bit 0 of ``words`` ([NW] int32, big-endian): int64 [C + 1],
    every chunk's first bit, then the bit after the last symbol.

    Pointer doubling, as the kernel: the length of the code at every bit
    position from the fixed-iteration binary search over the XOR-mapped
    codewords (mid <= n-1 clamp); next(p) = p + length (positions past the
    words sink at their end); next**chunk_size by repeated squaring
    (``chunk_size`` a power of two); the chunk starts by C - 1 jumps and the
    end by the last chunk's steps, walked on the host where the kernel walks
    groups of 16 chunks on the device."""
    if chunk_size < 1 or chunk_size & (chunk_size - 1):
        raise ValueError(f"chunk_size must be a power of two, got {chunk_size}")
    dev = words.device
    C = -(-n_symbols // chunk_size)
    if n_symbols == 0:
        return torch.zeros(C + 1, dtype=torch.int64, device=dev)
    n = cw_map.shape[0]
    P = words.shape[0] * 32
    w64 = words.to(torch.int64) & _M32
    pos = torch.arange(P, dtype=torch.int64, device=dev)
    wi, sh = pos >> 5, pos & 31
    nxt = torch.cat([w64[1:], w64.new_zeros(1)])
    w = ((w64[wi] << sh) | (nxt[wi] >> (32 - sh))) & _M32
    wm = w ^ 0x80000000
    wm = wm - ((wm >> 31) << 32)  # int32 value of the mapped window
    del w, nxt, wi, sh
    cw = cw_map.to(torch.int64)
    low = torch.zeros(P, dtype=torch.int64, device=dev)
    high = torch.full((P,), n, dtype=torch.int64, device=dev)
    for _ in range(max(n.bit_length(), 1)):
        mid = torch.clamp((low + high) >> 1, max=n - 1)
        go = cw[mid] <= wm
        low = torch.where(go, mid + 1, low)
        high = torch.where(go, high, mid)
    step = len_sorted.to(torch.int64)[(low - 1).clamp(min=0)]
    one = torch.cat([torch.clamp(pos + step, max=P), pos.new_full((1,), P)])  # [P + 1]
    del low, high, mid, go, step, wm, pos
    jump = one
    for _ in range(chunk_size.bit_length() - 1):
        jump = jump[jump]
    by_chunk, by_one = jump.cpu().numpy(), one.cpu().numpy()
    starts = [0]
    for _ in range(C - 1):
        starts.append(int(by_chunk[starts[-1]]))
    p = starts[-1]
    for _ in range(n_symbols - (C - 1) * chunk_size):
        p = int(by_one[p])
    return torch.tensor(starts + [p], dtype=torch.int64, device=dev)


def group_hist_ref(x: torch.Tensor, edges: torch.Tensor):
    """Group ids and their histogram: ids = clip(#{j < G : edges[j] <= x} - 1,
    0, G-1) (int32, ``x``'s shape) and hist [G] int32.  For sorted edges and
    finite x the ids equal ``searchsorted(edges, x, side="right") - 1``
    clipped; a NaN lands in group 0."""
    G = edges.shape[0] - 1
    count = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for j in range(G):
        count += x >= edges[j]
    ids = (count - 1).clamp_(0, G - 1)
    return ids, torch.bincount(ids.reshape(-1), minlength=G).to(torch.int32)


# -- the group-wise enhancer -------------------------------------------------

def enhancer_grouped_ref(x: torch.Tensor, ids: torch.Tensor | None, packed: torch.Tensor, *,
                         mode: str, clamp_eb: float | None = None) -> torch.Tensor:
    """Group-wise enhancer forward on slices x [B, H, W]: each pixel p of
    group g = ids[p] (None: all 0; clipped to [0, G)) gets model g applied
    to (x - lo_g) / scale_g masked to group g, then the ``mode`` epilogue
    (``pred``; ``residual``: x + pred rscale_g, x where rscale_g = 0;
    ``direct``: pred scale_g + lo_g) and an optional clip to x -+ clamp_eb.

    This is the reference's all-G masked form, written with elementwise ops
    only and in the CUDA kernel's loop order (channels outer, neighbours
    inner, taps innermost), so each pixel's value is independent of the
    batch and agrees with the kernel up to its fused multiply-adds."""
    G, C = packed.shape[0], enhancer_channels(packed)
    B, H, W = x.shape
    lo, sc, b2, rs = (packed[:, i] for i in range(4))
    w1 = packed[:, 4 : 4 + 9 * C].reshape(G, 9, C)
    b1, bs, bt = (packed[:, 4 + 9 * C + i * C : 4 + 9 * C + (i + 1) * C] for i in range(3))
    w2 = packed[:, 4 + 12 * C :].reshape(G, 9, C)
    ids = (torch.zeros(x.shape, dtype=torch.int64, device=x.device) if ids is None
           else ids.clamp(0, G - 1))
    # neighbours q of the slice's pixels form an (H+2) x (W+2) domain; h is 0
    # on its outer ring, which lies outside the slice
    ring = F.pad(torch.ones((H, W), dtype=torch.bool, device=x.device), (1, 1, 1, 1))
    out = torch.zeros_like(x)
    for g in range(G):
        m = ids == g
        xin = torch.where(m, (x - lo[g]) / sc[g], 0.0)
        xp = F.pad(xin, (2, 2, 2, 2))
        pred = torch.zeros_like(x)
        for c in range(C):
            a = torch.zeros((B, H + 2, W + 2), dtype=x.dtype, device=x.device)
            for k in range(9):
                dy, dx = divmod(k, 3)
                a = a + w1[g, k, c] * xp[:, dy : dy + H + 2, dx : dx + W + 2]
            a = a + b1[g, c]
            h = torch.where(ring, torch.relu(a * bs[g, c] + bt[g, c]), 0.0)
            for d2 in range(9):
                dy, dx = divmod(d2, 3)
                pred = pred + w2[g, d2, c] * h[:, dy : dy + H, dx : dx + W]
        pred = pred + b2[g]
        if mode == "residual":
            o = torch.where(rs[g] == 0, x, x + pred * rs[g])
        elif mode == "direct":
            o = pred * sc[g] + lo[g]
        elif mode == "pred":
            o = pred
        else:
            raise ValueError(f"unknown enhancer mode {mode!r}")
        out = torch.where(m, o, out)
    if clamp_eb is not None:
        eb = float(np.float32(clamp_eb))
        out = torch.minimum(torch.maximum(out, x - eb), x + eb)
    return out


def enhancer_fused_ref(x, w1, b1, gamma, beta, mean, var, w2, b2) -> torch.Tensor:
    """One enhancer (reference layout: w1 [3, 3, 1, C], w2 [3, 3, C, 1],
    b2 [1]) on x [B, H, W]: conv3x3 -> BN (inference) -> ReLU -> conv3x3,
    zero SAME padding.  The G = 1 case of :func:`enhancer_grouped_ref`,
    where (x - 0) / 1 is exact."""
    return enhancer_grouped_ref(x, None, single_enhancer(w1, b1, gamma, beta, mean, var,
                                                         w2, b2), mode="pred")
