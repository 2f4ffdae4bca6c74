"""Plain canonical-Huffman decode of many lanes at once, in torch.

Every chunk of every lane walks its own bit stream one symbol a step, all
chunks in lockstep: the code length of the 32-bit window at a chunk's bit
position is the least length ``l`` whose left-aligned canonical limit
``(first_code[l] + count[l]) << (32 - l)`` lies above the window, and the
symbol is the ``(window >> (32 - l)) - first_code[l]``-th of that length in
canonical order (length, then alphabet index).  One table a lane; no
multi-symbol lookup, no escape path.  The program's decoder reads the same
bits by another method (a multi-symbol probe table), so the two agree only
where both read the format right.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.container import HuffmanLane

_MAX_LEN = 32
_NEVER = 1 << 40  # a limit no 32-bit window reaches


def _canonical_tables(lane: HuffmanLane):
    """(limits [33], first_code [33], first_idx [33], symbols in canonical order)."""
    lengths = lane.lengths
    count = np.bincount(lengths, minlength=_MAX_LEN + 1)[: _MAX_LEN + 1]
    count[0] = 0
    first_code = np.zeros(_MAX_LEN + 1, np.int64)
    first_idx = np.zeros(_MAX_LEN + 1, np.int64)
    limits = np.full(_MAX_LEN + 1, _NEVER, np.int64)
    code = idx = 0
    for ln in range(1, _MAX_LEN + 1):
        first_code[ln], first_idx[ln] = code, idx
        limits[ln] = (code + count[ln]) << (32 - ln)
        code = (code + count[ln]) << 1
        idx += count[ln]
    order = np.lexsort((np.arange(lengths.size), lengths))
    return limits, first_code, first_idx, lane.alphabet[order]


def decode_lanes(lanes: list[HuffmanLane], device) -> torch.Tensor:
    """int32 symbols [L, n] of lanes that all hold ``n`` symbols."""
    L = len(lanes)
    n = lanes[0].n
    cs = lanes[0].chunk
    if any(ln.n != n or ln.chunk != cs for ln in lanes):
        raise ValueError("lanes of different sizes")
    C = -(-n // cs)
    tabs = [_canonical_tables(ln) for ln in lanes]
    limits = torch.from_numpy(np.stack([t[0][1:] for t in tabs])).to(device)  # [L, 32]
    first_code = torch.from_numpy(np.stack([t[1] for t in tabs])).to(device)  # [L, 33]
    first_idx = torch.from_numpy(np.stack([t[2] for t in tabs])).to(device)
    sym_off = np.concatenate([[0], np.cumsum([t[3].size for t in tabs])[:-1]])
    symbols = torch.from_numpy(np.concatenate([t[3] for t in tabs]).astype(np.int32)).to(device)
    # all streams in one array of big-endian 32-bit words, each lane padded to
    # whole words, and two zero words at the end for the window's second word
    words, word_off = [], [0]
    for ln in lanes:
        raw = np.frombuffer(ln.stream, np.uint8)
        raw = np.concatenate([raw, np.zeros((-raw.size) % 4, np.uint8)])
        words.append(raw.view(">u4").astype(np.int64))
        word_off.append(word_off[-1] + words[-1].size)
    words.append(np.zeros(2, np.int64))
    w = torch.from_numpy(np.concatenate(words)).to(device)
    starts = np.stack([np.concatenate([[0], np.cumsum(ln.chunk_bits)[:-1]]) for ln in lanes])
    pos = torch.from_numpy((starts + 32 * np.asarray(word_off[:-1])[:, None]).reshape(-1)).to(device)
    lane = torch.arange(L, device=device).repeat_interleave(C)
    todo = torch.full((C,), cs, dtype=torch.int64)
    todo[-1] = n - cs * (C - 1)
    todo = todo.repeat(L).to(device)
    out = torch.zeros((L * C, cs), dtype=torch.int32, device=device)
    lane_limits = limits[lane]  # [L * C, 32]
    lane_sym = torch.from_numpy(sym_off).to(device)[lane]
    top = symbols.numel() - 1
    for step in range(cs):
        live = todo > step
        wi = pos >> 5
        sh = pos & 31
        window = ((w[wi] << sh) | (w[wi + 1] >> (32 - sh))) & 0xFFFFFFFF
        # past the end of a stream (or in a damaged one) no length may fit:
        # the clamps keep the lookups in range, and such a symbol is wrong
        ln = ((lane_limits <= window[:, None]).sum(1) + 1).clamp_(max=_MAX_LEN)
        code = window >> (32 - ln)
        k = first_idx[lane, ln] + code - first_code[lane, ln]
        sym = symbols[(lane_sym + k).clamp_(0, top)]
        out[:, step] = torch.where(live, sym, 0)
        pos = torch.where(live, pos + ln, pos)
    return out.view(L, C * cs)[:, :n]
