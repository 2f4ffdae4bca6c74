"""Entropy stage: chunked canonical Huffman + zlib (port of
``repro/sz/entropy.py``; blob layout in docs/ENTROPY_FORMAT.md).

Split between host and device:

* on the device (the tensor's own: CUDA kernels on the card, their plain
  PyTorch versions on the CPU) -- the symbol histograms of the fit, the
  chunk-parallel encode pack and the multi-symbol LUT decode.  A batch of
  lanes (the tiles of a GWTC container) is fitted and packed with one launch
  of each encode kernel (:func:`encode_codes_lanes`);
* on the host, as numpy -- the Huffman tree (``_code_lengths``), canonical
  codes, decode tables, the splice of packed chunks into one stream
  (``_splice_chunks``), zlib and the blob framing.  A call of several
  lanes frames and deflates them on one process-wide pool of host threads
  (:class:`_Deflate`; zlib releases the interpreter lock), while the
  caller splices the next lane.

Blobs are byte-identical to the reference's for the ``z2``/``z4`` (zlib),
``hc``/``hZ`` (chunked Huffman) and legacy ``hf``/``hz`` (one Huffman
stream, no chunk table; :func:`encode_codes_legacy`) tags.  The per-symbol
work never leaves the symbols' device: what the kernels cannot take is
refused with a ``ValueError`` on every device -- a table with a code longer
than 32 bits (no encoder writes one) or a chunk larger than the encode
kernel's shared memory (:data:`MAX_CHUNK`).  Bit positions are 64-bit on
every device, so a stream may run past 2**32 bits.

A legacy stream decodes in two launches (:meth:`HuffmanCodec.decode_bitwalk`):
a boundary pass walks it once and finds every chunk's start bit, then the
chunked decode kernel decodes the chunks in parallel, so it gives the same
ids as a chunked stream.  :func:`decode_codes_range` reads a symbol range
of an ``hc``/``hZ`` blob by decoding only the chunks that cover it.
"""
from __future__ import annotations

import heapq
import math
import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.errors import CorruptContainerError
from repro_torch.kernels import ops
from repro_torch.kernels.huffman_encode import MAX_CHUNK
from repro_torch.sz.artifact import ENTROPY_MAGIC

_MAGIC = ENTROPY_MAGIC

DEFAULT_CHUNK = 256  # symbols per independently decodable chunk
_LUT_BITS = 12  # primary decode-table width cap (2**k entries)
_FMT_CODE_LEN = 32  # FROZEN in the hc/hZ blob format (chunk-table width rule)
_MAX_CODE_LEN = _FMT_CODE_LEN  # encoder policy; must never exceed _FMT_CODE_LEN
_DENSE_SPAN = 1 << 22  # wider alphabets are counted by torch.unique
_LANES_SPAN = 1 << 16  # lanes up to this span are fitted and packed together
_HIST_BINS = 1 << 26  # rows x bins of one batched lane histogram (and its rank table)


def _chunk_bits_dtype(chunk_size: int) -> str:
    """Chunk-table entry width: u16 whenever a full chunk of max-length codes
    fits (wire format, pinned to the frozen ``_FMT_CODE_LEN``)."""
    return "<u2" if chunk_size * _FMT_CODE_LEN <= 0xFFFF else "<u4"


def shannon_bits(symbols) -> float:
    """Ideal entropy-coded size in bits (a lower bound for any entropy
    coder) of a tensor or array.  Integer alphabets spanning at most 2**22
    values are counted by ``torch.bincount``; wider ones and floats by
    ``torch.unique``."""
    flat = torch.as_tensor(symbols).reshape(-1)
    if flat.numel() == 0:
        return 0.0
    counts = None
    if not (flat.is_floating_point() or flat.is_complex()):
        lo, hi = torch.stack(torch.aminmax(flat)).tolist()
        if hi - lo + 1 <= _DENSE_SPAN:
            counts = torch.bincount(flat.to(torch.int64) - lo)
            counts = counts[counts > 0]
    if counts is None:
        counts = torch.unique(flat, return_counts=True)[1]
    p = counts.to(torch.float64) / counts.sum()
    return float(-(p * torch.log2(p)).sum() * flat.numel())


# ---------------------------------------------------------------------------
# Canonical Huffman (host)
# ---------------------------------------------------------------------------


def _code_lengths(counts: np.ndarray) -> np.ndarray:
    """Huffman code length per symbol from frequency counts (heap build)."""
    n = len(counts)
    if n == 0:
        return np.zeros(0, np.int64)
    if n == 1:
        return np.array([1], np.int64)
    heap = [(int(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = np.full(2 * n - 1, -1, np.int64)
    nxt = n
    while len(heap) > 1:
        c1, i1 = heapq.heappop(heap)
        c2, i2 = heapq.heappop(heap)
        parent[i1] = nxt
        parent[i2] = nxt
        heapq.heappush(heap, (c1 + c2, nxt))
        nxt += 1
    depth = np.zeros(2 * n - 1, np.int64)
    for i in range(nxt - 2, -1, -1):  # parents always have higher index
        depth[i] = depth[parent[i]] + 1
    return depth[:n]


def _limited_code_lengths(counts: np.ndarray, max_len: int = _MAX_CODE_LEN) -> np.ndarray:
    """Code lengths capped at ``max_len`` by count-halving."""
    c = np.asarray(counts, np.int64)
    lengths = _code_lengths(c)
    while lengths.size and int(lengths.max()) > max_len:
        c = (c + 1) >> 1
        lengths = _code_lengths(c)
    return lengths


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical codewords (uint64) for the given code lengths."""
    order = np.lexsort((np.arange(len(lengths)), lengths))
    codes = np.zeros(len(lengths), np.uint64)
    code = 0
    prev_len = 0
    for sym in order:
        L = int(lengths[sym])
        code <<= L - prev_len
        codes[sym] = code
        code += 1
        prev_len = L
    return codes


def _splice_chunks(local: np.ndarray, chunk_bits: np.ndarray) -> tuple[bytes, int]:
    """Join per-chunk word-packed bit streams into one continuous MSB-first
    byte stream (hc/hZ chunks are not byte-aligned).

    ``local`` is uint32 [C, W]: chunk c's bits fill its first
    ceil(chunk_bits[c]/32) words, zeros beyond (W may be cut to the widest
    chunk).  Each chunk shifts right by its global bit offset mod 32 and
    lands at word offset>>5; neighbours share at most one word with
    disjoint bits, so the scatter-OR is one exact float64 ``bincount``."""
    C, W = local.shape
    ends = np.cumsum(chunk_bits, dtype=np.int64)
    total = int(ends[-1]) if C else 0
    offs = ends - chunk_bits
    sh = (offs & 31).astype(np.uint32)[:, None]
    shifted = np.zeros((C, W + 1), np.uint32)
    shifted[:, :W] = local >> sh
    shifted[:, 1:] |= (local << (np.uint32(31) - sh)) << np.uint32(1)
    idx = (offs >> 5)[:, None] + np.arange(W + 1, dtype=np.int64)
    nwords = (total + 31) // 32
    out = np.bincount(idx.ravel(), weights=shifted.ravel().astype(np.float64),
                      minlength=nwords + 1)[:nwords]
    stream = out.astype(np.int64).astype(np.uint32).astype(">u4").tobytes()
    return stream[: (total + 7) // 8], total


class _Tables(NamedTuple):
    """Canonical decode tables (per codec, built lazily)."""

    max_len: int
    k: int  # single-symbol LUT width in bits
    first_code: np.ndarray  # per-length canonical decode bases (bit walk)
    first_idx: np.ndarray
    count_at: np.ndarray
    order: np.ndarray  # symbol ids in canonical order
    lut: np.ndarray  # single-symbol LUT: (sym+1)<<8 | len, 0 = escape
    cw_left: np.ndarray  # left-aligned canonical codewords (monotone)
    L_sorted: np.ndarray  # code lengths in canonical order


class _MultiTables(NamedTuple):
    tables: _Tables
    mlut: np.ndarray  # multi-symbol probe LUT (see _multi_lut)
    B: int  # bits per symbol id slot
    S: int  # id slots per probe entry


def _id_shift0(B: int) -> int:
    """Bit offset of the first symbol id in a packed probe entry."""
    return 32 if B == 32 else 16


def _multi_lut(lut1: np.ndarray, k: int, B: int, S: int) -> np.ndarray:
    """Multi-symbol LUT: entry packs count (byte 0), consumed bits (byte 1)
    and up to S symbol ids (B-bit slots from ``_id_shift0``), greedily
    covering every complete code in the k-bit window; 0 = escape."""
    size = 1 << k
    W = np.arange(size, dtype=np.uint64)
    kmask = np.uint64(size - 1)
    consumed = np.zeros(size, np.uint64)
    count = np.zeros(size, np.uint64)
    acc = np.zeros(size, np.uint64)
    active = np.ones(size, bool)
    base = _id_shift0(B)
    for j in range(S):
        sub = (W << consumed) & kmask
        e1 = lut1[sub]
        ln = e1 & np.uint64(0xFF)
        ok = active & (e1 != 0) & (consumed + ln <= k)
        if not ok.any():
            break
        sym = (e1[ok] >> np.uint64(8)) - np.uint64(1)
        acc[ok] |= sym << np.uint64(base + j * B)
        consumed[ok] += ln[ok]
        count[ok] += np.uint64(1)
        active = ok
    return acc | (consumed << np.uint64(8)) | count


def _stream_words(stream: bytes, w0: int, w1: int | None, device) -> torch.Tensor:
    """Big-endian u32 words w0 .. w1-1 (None: to the end) of a byte stream,
    as int32 on ``device``, zero-padded past the stream plus 2 zero tail
    words for the decode's wi+1 gather."""
    lo = min(4 * w0, len(stream))
    hi = len(stream) if w1 is None else min(4 * w1, len(stream))
    raw = np.frombuffer(stream, np.uint8, max(hi - lo, 0), lo)
    padded = np.zeros(raw.size + (-raw.size) % 4 + 8, np.uint8)
    padded[: raw.size] = raw
    return torch.from_numpy(padded.view(">u4").astype(np.uint32).view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------


@dataclass
class HuffmanCodec:
    """Canonical Huffman over a dense alphabet.

    ``alphabet`` (sorted symbol values), ``lengths`` and ``codes`` are host
    numpy arrays; the per-symbol work runs on the symbols' device."""

    alphabet: np.ndarray
    lengths: np.ndarray
    codes: np.ndarray

    @staticmethod
    def fit(symbols: torch.Tensor) -> "HuffmanCodec":
        """Fit to an integer tensor on its device: dense alphabets (span
        <= 2**22) are counted by ``symbol_hist_op``, wider (sparse) ones by
        ``torch.unique``, where the reference takes ``np.unique``."""
        flat = symbols.reshape(-1).to(torch.int32)
        if flat.numel() == 0:
            empty = np.zeros(0, np.int64)
            return HuffmanCodec(np.zeros(0, np.int32), empty, empty.astype(np.uint64))
        lo, hi = torch.stack(torch.aminmax(flat)).tolist()
        span = hi - lo + 1
        if span <= _DENSE_SPAN:
            shifted = flat - lo  # in [0, span): no int32 overflow
            hist = ops.symbol_hist_op(shifted, n_bins=span)
            counts_full = hist.cpu().numpy()
            nz = np.flatnonzero(counts_full)
            alphabet = (nz + lo).astype(np.int32)
            counts = counts_full[nz].astype(np.int64)
            rank = torch.cumsum(hist > 0, 0) - 1  # symbol value -> alphabet index
            inv = rank[shifted.to(torch.int64)]
        else:
            values, inv, counts_t = torch.unique(flat, return_inverse=True,
                                                 return_counts=True)
            alphabet = values.cpu().numpy()
            counts = counts_t.cpu().numpy().astype(np.int64)
        lengths = _limited_code_lengths(counts)
        codec = HuffmanCodec(alphabet, lengths, _canonical_codes(lengths))
        codec._inv = inv  # the remap of the fitted symbols, for the next encode
        return codec

    def _symbol_ranks(self, flat: torch.Tensor) -> torch.Tensor:
        # fit() leaves the remap of the tensor it fitted for the encode that
        # follows; it is used once, and only when the sizes match
        inv = self.__dict__.pop("_inv", None)
        if inv is None or inv.numel() != flat.numel():
            alpha = torch.from_numpy(self.alphabet.astype(np.int64)).to(flat.device)
            inv = torch.searchsorted(alpha, flat.to(torch.int64))
        return inv

    # -- encode ---------------------------------------------------------------
    def _check_lengths(self) -> None:
        """The kernels work in 32-bit windows.  Every codec this package or
        the reference fits caps its lengths there, so a longer code can only
        come from a damaged table."""
        if self.lengths.size and int(self.lengths.max()) > _FMT_CODE_LEN:
            raise CorruptContainerError(
                f"corrupt Huffman table: a {int(self.lengths.max())}-bit code (the format "
                f"caps codes at {_FMT_CODE_LEN} bits)")

    def _pack_inputs(self, flat: torch.Tensor, chunk_size: int):
        """Per-symbol code lengths and codewords of ``flat`` as [C, chunk_size]
        int32 tensors on its device (zero-length pad slots after the end):
        the encode kernel's inputs."""
        n = flat.numel()
        dev = flat.device
        inv = self._symbol_ranks(flat)
        C = -(-n // chunk_size)
        lens = torch.zeros(C * chunk_size, dtype=torch.int32, device=dev)
        cws = torch.zeros(C * chunk_size, dtype=torch.int32, device=dev)
        lens[:n] = torch.from_numpy(self.lengths.astype(np.int32)).to(dev)[inv]
        cw32 = self.codes.astype(np.uint32).view(np.int32)
        cws[:n] = torch.from_numpy(cw32).to(dev)[inv]
        return lens.view(C, chunk_size), cws.view(C, chunk_size)

    def _device_pack(self, flat: torch.Tensor, chunk_size: int):
        """Pack on ``flat``'s device: returns (stream bytes, chunk_bits int64,
        total bits)."""
        self._check_lengths()
        with obs.span("entropy.pack"):
            words, chunk_bits = ops.huffman_encode_op(*self._pack_inputs(flat, chunk_size))
            bits = chunk_bits.cpu().numpy().astype(np.int64)
            used = -(-int(bits.max()) // 32)  # words past the widest chunk are zero
            local = words[:, :used].contiguous().cpu().numpy().view(np.uint32)
        with obs.span("entropy.splice"):
            stream, total = _splice_chunks(local, bits)
        return stream, bits, total

    # -- decode tables ----------------------------------------------------------
    def _decode_tables(self) -> _Tables:
        cached = getattr(self, "_tables", None)
        if cached is not None:
            return cached
        n = len(self.lengths)
        max_len = int(self.lengths.max()) if n else 0
        k = min(max_len, _LUT_BITS)
        order = np.lexsort((np.arange(n), self.lengths))
        count_at = np.bincount(self.lengths.astype(np.int64), minlength=max_len + 2)
        first_code = np.zeros(max_len + 2, np.int64)
        first_idx = np.zeros(max_len + 2, np.int64)
        code = idx = 0
        for L in range(1, max_len + 1):
            first_code[L] = code
            first_idx[L] = idx
            code = (code + count_at[L]) << 1
            idx += count_at[L]
        lut = np.zeros(1 << k, np.uint64)
        L_sorted = self.lengths[order].astype(np.int64)
        if n:
            short = L_sorted <= k  # prefix of the canonical order
            widths = np.left_shift(1, k - L_sorted[short])
            packed = ((order[short] + 1) << 8) | L_sorted[short]
            lut[: int(widths.sum())] = np.repeat(packed, widths).astype(np.uint64)
        cw_left = self.codes[order] << (64 - L_sorted).astype(np.uint64)
        tables = _Tables(max_len, k, first_code, first_idx, count_at, order,
                         lut, cw_left, L_sorted)
        self._tables = tables
        return tables

    def _multi_tables(self) -> _MultiTables:
        cached = getattr(self, "_mtables", None)
        if cached is not None:
            return cached
        tables = self._decode_tables()
        n = len(self.alphabet)
        B = 8 if n <= 256 else (16 if n <= 65536 else 32)
        S = (64 - _id_shift0(B)) // B  # 6 / 3 / 1 ids per probe entry
        mtables = _MultiTables(tables, _multi_lut(tables.lut, tables.k, B, S), B, S)
        self._mtables = mtables
        return mtables

    def _device_tables(self):
        """The multi-symbol LUT split into int32 arrays for the decode
        kernel.  Cached."""
        cached = getattr(self, "_dev_tables", None)
        if cached is not None:
            return cached
        self._check_lengths()
        mt = self._multi_tables()
        t = mt.tables
        base = _id_shift0(mt.B)
        mask = np.uint64((1 << mt.B) - 1)
        lut_ids = np.stack([
            ((mt.mlut >> np.uint64(base + j * mt.B)) & mask).astype(np.int32)
            for j in range(mt.S)])
        # codes fill the top <= 32 bits, so the top-32 truncation keeps every
        # interval boundary; the XOR maps unsigned order onto int32 order
        cw32 = (t.cw_left >> np.uint64(32)).astype(np.uint32)
        dev = {
            "lut_count": (mt.mlut & np.uint64(0xFF)).astype(np.int32),
            "lut_bits": ((mt.mlut >> np.uint64(8)) & np.uint64(0xFF)).astype(np.int32),
            "lut_ids": lut_ids,
            "cw_map": (cw32 ^ np.uint32(0x80000000)).view(np.int32),
            "order": t.order.astype(np.int32),
            "len_sorted": t.L_sorted.astype(np.int32),
            "k": t.k,
        }
        self._dev_tables = dev
        return dev

    def _tables_on(self, device: torch.device) -> dict:
        """``_device_tables`` plus the alphabet and the packed multi-symbol
        LUT (``lut``: ``_multi_lut``'s uint64 bits as int64, which the CUDA
        decode reads) as tensors on ``device`` (cached per device; building
        twice under a race is harmless)."""
        per_dev = self.__dict__.setdefault("_dev_tensors", {})
        key = str(device)
        got = per_dev.get(key)
        if got is None:
            host = dict(self._device_tables())
            k = host.pop("k")
            host["alphabet"] = self.alphabet.astype(np.int32)
            host["lut"] = self._multi_tables().mlut.view(np.int64)
            got = {name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for name, a in host.items()}
            got["k"] = k
            per_dev[key] = got
        return got

    # -- decode -------------------------------------------------------------------
    @obs.spanned("lane.decode")
    def decode_chunked_device(self, stream: bytes, n_symbols: int, chunk_size: int,
                              chunk_bits: np.ndarray, *, total_bits: int | None,
                              device: torch.device, chunk_range=None) -> torch.Tensor:
        """Decode a chunked stream on ``device``; returns int32 symbols.
        ``chunk_range=(c0, c1)`` decodes only chunks c0 .. c1-1 (and uploads
        only their words): the symbols from c0 * chunk_size on."""
        if n_symbols == 0:
            return torch.zeros(0, dtype=torch.int32, device=device)
        if self.alphabet.size == 0:
            raise ValueError("empty codec cannot decode a nonempty stream")
        chunk_bits = np.asarray(chunk_bits, np.int64)
        C = chunk_bits.size
        if C != -(-n_symbols // chunk_size):
            raise ValueError("chunk table size inconsistent with symbol count")
        ends = np.cumsum(chunk_bits)
        total = int(ends[-1])
        if total_bits is not None and total != total_bits:
            raise ValueError("chunk table inconsistent with stream length")
        if len(stream) < (total + 7) // 8:
            raise ValueError("truncated Huffman stream")
        # bit positions are int64; a chunk's own bits must stay below 2**31
        if chunk_size * _FMT_CODE_LEN >= 1 << 31:
            raise ValueError(f"Huffman chunks of {chunk_size} symbols are past the "
                             "decoder's int32 chunk lengths")
        c0, c1 = (0, C) if chunk_range is None else chunk_range
        offsets = ends - chunk_bits
        w0 = int(offsets[c0]) >> 5  # the first word the range reads
        w1 = -(-int(ends[c1 - 1]) // 32)  # past the last word it reads
        args, kw = self._decode_inputs(stream, n_symbols, chunk_size, offsets, device,
                                       chunk_range=(c0, c1), word_range=(w0, w1))
        return self._ids_to_symbols(args, kw, min(n_symbols, c1 * chunk_size) - c0 * chunk_size,
                                    device)

    def _ids_to_symbols(self, args, kw, n_out: int, device: torch.device) -> torch.Tensor:
        """Run the chunked decode kernel on its inputs and map the first
        ``n_out`` ids (only the last chunk can be short, so the row-major
        flatten is the symbol stream) to alphabet values."""
        tabs = self._tables_on(device)
        ids = ops.huffman_decode_op(*args, **kw, lut=tabs["lut"])
        return tabs["alphabet"][ids.reshape(-1)[:n_out]]

    def _decode_inputs(self, stream: bytes, n_symbols: int, chunk_size: int,
                       offsets, device: torch.device, *, chunk_range=None,
                       word_range=None):
        """The decode kernel's arguments on ``device``: (words, offsets,
        counts, six tables) and (chunk_size, k).  ``offsets`` are every
        chunk's start bit; ``chunk_range`` keeps chunks c0 .. c1-1 and
        ``word_range`` uploads only stream words w0 .. w1-1, the offsets
        shifted to match."""
        tabs = self._tables_on(device)
        C = offsets.shape[0]
        c0, c1 = (0, C) if chunk_range is None else chunk_range
        counts = np.full(C, chunk_size, np.int32)
        counts[-1] = n_symbols - chunk_size * (C - 1)
        w0, w1 = (0, None) if word_range is None else word_range
        words = _stream_words(stream, w0, w1, device)
        offs = torch.from_numpy(np.asarray(offsets[c0:c1], np.int64) - 32 * w0).to(device)
        args = (words, offs, torch.from_numpy(counts[c0:c1]).to(device), tabs["lut_count"],
                tabs["lut_bits"], tabs["lut_ids"], tabs["cw_map"], tabs["order"],
                tabs["len_sorted"])
        return args, {"chunk_size": chunk_size, "k": tabs["k"]}

    def decode_bitwalk(self, blob, n_symbols: int, *, device) -> torch.Tensor:
        """Decode a legacy stream (``hf``/``hz``: a <Q bit count, then the
        codes MSB-first, no chunk table) on ``device``; returns int32
        symbols.  A boundary pass (``ops.huffman_legacy_bounds_op``) finds
        the start bit of every :data:`DEFAULT_CHUNK` symbols, then the
        chunked decode decodes those chunks in parallel; the pass's end must
        land on the stream's bit count."""
        device = torch.device(device)
        if n_symbols == 0:
            return torch.zeros(0, dtype=torch.int32, device=device)
        if self.alphabet.size == 0:
            raise ValueError("empty codec cannot decode a nonempty stream")
        (total,) = struct.unpack_from("<Q", blob, 0)
        stream = bytes(blob[8:])
        if len(stream) < (total + 7) // 8:
            raise ValueError("truncated Huffman stream")
        tabs = self._tables_on(device)
        words = _stream_words(stream, 0, None, device)
        cs = DEFAULT_CHUNK
        bounds = ops.huffman_legacy_bounds_op(words, tabs["cw_map"], tabs["len_sorted"],
                                              n_symbols=n_symbols, chunk_size=cs)
        end = int(bounds[-1])
        if end != total:
            raise ValueError(f"legacy Huffman stream of {total} bits ends its "
                             f"{n_symbols} symbols at bit {end}")
        C = bounds.shape[0] - 1
        counts = np.full(C, cs, np.int32)
        counts[-1] = n_symbols - cs * (C - 1)
        args = (words, bounds[:C], torch.from_numpy(counts).to(device), tabs["lut_count"],
                tabs["lut_bits"], tabs["lut_ids"], tabs["cw_map"], tabs["order"],
                tabs["len_sorted"])
        return self._ids_to_symbols(args, {"chunk_size": cs, "k": tabs["k"]}, n_symbols,
                                    device)

    # -- serialization --------------------------------------------------------------
    def table_bytes(self) -> bytes:
        return (
            struct.pack("<I", len(self.alphabet))
            + self.alphabet.astype(np.int32).tobytes()
            + self.lengths.astype(np.uint8).tobytes()
        )

    @staticmethod
    def from_table(blob: bytes) -> tuple["HuffmanCodec", int]:
        (n,) = struct.unpack_from("<I", blob, 0)
        off = 4
        alphabet = np.frombuffer(blob, np.int32, n, offset=off).copy()
        off += 4 * n
        lengths = np.frombuffer(blob, np.uint8, n, offset=off).astype(np.int64)
        off += n
        return HuffmanCodec(alphabet, lengths, _canonical_codes(lengths)), off


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


def _zlib_blob(host: np.ndarray) -> bytes:
    """``z2``/``z4`` blob of int32 codes (host numpy)."""
    # int32 -> int16 when it fits (usual case): halves the zlib input.  The
    # reference tests abs(codes) < 2**15, which passes -2**31 (its abs wraps)
    # and then writes it as 0; this test agrees with it on every other input.
    if host.size and -(2**15) < host.min() and host.max() < 2**15:
        payload = zlib.compress(host.astype(np.int16).tobytes(), 6)
        tag = b"z2"
    else:
        payload = zlib.compress(host.tobytes(), 6)
        tag = b"z4"
    return _MAGIC + tag + struct.pack("<Q", host.size) + payload


def _huffman_blob(codec: HuffmanCodec, n: int, cs: int, chunk_bits: np.ndarray, stream: bytes,
                  total: int, backend: str) -> bytes:
    """``hc``/``hZ`` framing of one packed stream."""
    # chunk table + bit stream travel together so zlib sees both
    payload = chunk_bits.astype(_chunk_bits_dtype(cs)).tobytes() + stream
    if backend == "huffman+zlib":
        payload = zlib.compress(payload, 6)
        tag = b"hZ"
    else:
        tag = b"hc"
    table = codec.table_bytes()
    return (_MAGIC + tag + struct.pack("<QIII", n, cs, chunk_bits.size, len(table))
            + table + struct.pack("<Q", total) + payload)


_POOL: tuple[int, int, ThreadPoolExecutor] | None = None  # (pid, workers, pool)
_POOL_LOCK = threading.Lock()
if hasattr(os, "register_at_fork"):  # a fork waits for the lock: no child inherits it held
    os.register_at_fork(before=_POOL_LOCK.acquire, after_in_parent=_POOL_LOCK.release,
                        after_in_child=_POOL_LOCK.release)


def _usable_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # not Linux
        return os.cpu_count() or 1


def _deflate_pool() -> tuple[ThreadPoolExecutor, int]:
    """The process's pool of host threads for the lanes' framing and zlib
    and its size, the usable cores; made on first use.  Every caller shares
    it (the serve daemon's requests, a stream's caller beside its writer
    thread), so their threads never outnumber the cores.  Keyed on the
    process id: a forked child makes its own and never queues work on
    threads it did not inherit."""
    global _POOL
    pid = os.getpid()
    with _POOL_LOCK:
        if _POOL is None or _POOL[0] != pid:
            workers = _usable_cores()
            _POOL = (pid, workers, ThreadPoolExecutor(workers, thread_name_prefix="lane-deflate"))
        return _POOL[2], _POOL[1]


class _Deflate:
    """One call's lane blobs: each lane's framing and zlib (``_huffman_blob``
    / ``_zlib_blob``) run on :func:`_deflate_pool` where the call has at
    least 2 lanes and the pool at least 2 workers, else on the caller in
    :meth:`blobs`.  The bytes and their order are the serial loop's.

    ``with _Deflate(L) as d:``, ``d.submit(i, fn, *args)`` as lane ``i``'s
    input is ready, then ``d.blobs()``: the call's one ``entropy.deflate``
    span, the caller's wait for blobs not yet finished (``lanes``;
    ``workers``, the threads it could use; ``pooled``).  No pool thread
    records a span: concurrent spans would sum to CPU seconds, not the
    call's.  Leaving the block, on an error too, cancels the lanes not yet
    started and waits for the others, so no lane's work outlives the call."""

    def __init__(self, lanes: int):
        self.lanes = lanes
        self.pool, self.workers = _deflate_pool() if lanes >= 2 else (None, 1)
        if self.workers < 2:
            self.pool, self.workers = None, 1
        self.jobs: list = [None] * lanes  # a Future each, or (fn, args) on the caller

    def submit(self, i: int, fn, *args) -> None:
        self.jobs[i] = self.pool.submit(fn, *args) if self.pool else (fn, args)

    def blobs(self) -> list[bytes]:
        with obs.span("entropy.deflate", lanes=self.lanes, workers=self.workers,
                      pooled=self.pool is not None):
            if self.pool is None:
                return [fn(*args) for fn, args in self.jobs]
            return [job.result() for job in self.jobs]

    def __enter__(self) -> "_Deflate":
        return self

    def __exit__(self, *exc) -> None:
        if self.pool is not None:
            jobs = [job for job in self.jobs if job is not None]
            for job in jobs:
                job.cancel()
            wait(jobs)


def encode_codes(codes: torch.Tensor, backend: str = "huffman+zlib", *,
                 chunk_size: int | None = None) -> bytes:
    """Entropy-encode an int32 code tensor into a self-describing blob
    (``z2``/``z4`` for zlib, ``hc``/``hZ`` for the Huffman backends): the
    one-lane call of :func:`encode_codes_lanes`."""
    return encode_codes_lanes(codes.reshape(1, -1), backend, chunk_size=chunk_size)[0]


def encode_codes_lanes(codes: torch.Tensor, backend: str = "huffman+zlib", *,
                       chunk_size: int | None = None) -> list[bytes]:
    """Encode each lane ``codes[l]`` of an int32 tensor [L, ...] into its own
    blob: exactly ``[encode_codes(codes[l], backend) for l in range(L)]``.

    The Huffman backends dispatch on each lane's span (max - min + 1).  Lanes
    spanning at most :data:`_LANES_SPAN` values are fitted and packed
    together on their device (:func:`_encode_lanes_batched`: one lane
    histogram launch, or a few where their histograms together would pass
    :data:`_HIST_BINS` bins, and one encode launch for all of them); a wider
    lane is fitted and packed alone (``HuffmanCodec.fit`` -- a dense
    histogram up to 2**22, ``torch.unique`` past it -- then
    ``_device_pack``), on the same device.  Either way the per-symbol work
    stays on the device and the bytes are the same.  Each lane's framing and
    zlib go to the host threads of :class:`_Deflate` as its input is ready."""
    L, n = codes.shape[0], math.prod(codes.shape[1:])
    with obs.span("entropy.encode", lanes=L) as sp:
        flat = codes.reshape(L, n).to(torch.int32)
        if backend == "zlib":
            host = flat.cpu().numpy()
            with _Deflate(L) as lanes:
                for i in range(L):
                    lanes.submit(i, _zlib_blob, host[i])
                return lanes.blobs()
        if backend not in ("huffman", "huffman+zlib"):
            raise ValueError(f"unknown entropy backend {backend!r}")
        cs = int(chunk_size) if chunk_size else DEFAULT_CHUNK
        if not 0 < cs <= MAX_CHUNK:
            raise ValueError(f"chunk size {cs} outside 1..{MAX_CHUNK} (one chunk's "
                             "words must fit the encode kernel's shared memory)")
        if L == 0 or n == 0:
            empty = HuffmanCodec(np.zeros(0, np.int32), np.zeros(0, np.int64),
                                 np.zeros(0, np.uint64))
            return [_huffman_blob(empty, 0, cs, np.zeros(0, np.int64), b"", 0, backend)] * L
        with obs.span("entropy.fit"):
            lo, hi = torch.aminmax(flat, dim=1)
            lo_h, hi_h = torch.stack([lo, hi]).cpu().numpy().astype(np.int64)
        span = hi_h - lo_h + 1
        batch = np.flatnonzero(span <= _LANES_SPAN)
        sp.set(batched=int(batch.size))
        with _Deflate(L) as lanes:
            for i in np.flatnonzero(span > _LANES_SPAN):
                with obs.span("entropy.fit"):
                    codec = HuffmanCodec.fit(flat[i])
                stream, chunk_bits, total = codec._device_pack(flat[i], cs)
                lanes.submit(i, _huffman_blob, codec, n, cs, chunk_bits, stream, total, backend)
            if batch.size:
                if batch.size < L:
                    keep = torch.from_numpy(batch).to(flat.device)
                    flat, lo = flat[keep], lo[keep]
                _encode_lanes_batched(flat, lo, lo_h[batch], span[batch], cs, backend,
                                      lanes, batch)
            return lanes.blobs()


def _encode_lanes_batched(flat: torch.Tensor, lo: torch.Tensor, lo_h: np.ndarray,
                          span: np.ndarray, cs: int, backend: str, lanes: _Deflate,
                          ids: np.ndarray) -> None:
    """Huffman blobs of the lanes ``flat`` [L, n] (int32; lane minima ``lo``
    on the device and ``lo_h`` on the host; spans ``span``), handed to
    ``lanes`` as lanes ``ids``: the inputs of :func:`_lanes_pack_inputs`,
    one encode launch over all lanes' chunks, one copy back of the chunk
    bits and one of the words up to the widest chunk, then per lane on the
    host the splice here and the framing and zlib on ``lanes``."""
    L, n = flat.shape
    with obs.span("entropy.fit"):
        codecs, lens, cws = _lanes_pack_inputs(flat, lo, lo_h, span, cs)
    with obs.span("entropy.pack"):
        words, chunk_bits = ops.huffman_encode_op(lens, cws)
        del lens, cws
        C = -(-n // cs)
        bits = chunk_bits.cpu().numpy().astype(np.int64).reshape(L, C)
        used = -(-int(bits.max()) // 32)  # words past the widest chunk are zero
        local = words[:, :used].contiguous().cpu().numpy().view(np.uint32).reshape(L, C, used)
    for i in range(L):
        with obs.span("entropy.splice"):
            stream, total = _splice_chunks(local[i, :, : -(-int(bits[i].max()) // 32)], bits[i])
        lanes.submit(ids[i], _huffman_blob, codecs[i], n, cs, bits[i], stream, total, backend)


def _hist_batches(span: np.ndarray, budget: int) -> list[np.ndarray]:
    """Lane indices in batches whose rows x widest span stays within
    ``budget`` (a lane wider than the budget alone): all lanes in order when
    they fit at once, else by ascending span."""
    L = span.size
    if L * int(span.max()) <= budget:
        return [np.arange(L)]
    order = np.argsort(span, kind="stable")
    batches, start = [], 0
    for j in range(1, L + 1):
        if j == L or (j - start + 1) * int(span[order[j]]) > budget:
            batches.append(order[start:j])
            start = j
    return batches


def _lanes_pack_inputs(flat: torch.Tensor, lo: torch.Tensor, lo_h: np.ndarray,
                       span: np.ndarray, cs: int):
    """Fit every lane of ``flat`` [L, n] and build the encode kernel's
    inputs for all of them: (codecs, lens, codes), lens/codes [L * C, cs]
    int32 with C = ceil(n / cs) chunks a lane.

    1. for each batch of :func:`_hist_batches` (one for all lanes unless
       L x max span passes :data:`_HIST_BINS`), one histogram launch
       [rows, widest span], one copy back, and per lane on the host the
       length-limited tree and canonical codes; on the device each symbol's
       rank among its lane's present values (cumsum of hist > 0);
    2. one upload of every lane's length and code tables, concatenated, with
       a zero-length entry at the end and each lane's offset;
    3. each symbol's table index, its rank plus its lane's offset, gathered
       at once; the pad slots of each lane's last chunk point at the
       zero-length entry, so no chunk crosses a lane."""
    dev = flat.device
    L, n = flat.shape
    C = -(-n // cs)
    idx = torch.empty((L, C * cs), dtype=torch.int32, device=dev)
    codecs: list[HuffmanCodec] = [None] * L  # type: ignore[list-item]
    for rows in _hist_batches(span, _HIST_BINS):
        sel = slice(None) if rows.size == L else torch.from_numpy(rows).to(dev)
        part, part_lo = flat[sel], lo[sel]
        hist = ops.symbol_hist_lanes_op(part, part_lo, n_bins=int(span[rows].max()))
        counts = hist.cpu().numpy()
        for j, i in enumerate(rows):
            present = np.flatnonzero(counts[j])
            lengths = _limited_code_lengths(counts[j, present])
            codecs[i] = HuffmanCodec((present + lo_h[i]).astype(np.int32), lengths,
                                     _canonical_codes(lengths))
        rank = torch.cumsum(hist > 0, dim=1, dtype=torch.int32)
        del hist
        sym = part.to(torch.int64)
        sym -= part_lo.to(torch.int64)[:, None]
        idx[sel, :n] = torch.gather(rank, 1, sym)
        del rank, sym, part
    sizes = np.array([c.alphabet.size for c in codecs], np.int64)
    n_tab = int(sizes.sum())
    host = np.zeros(2 * (n_tab + 1) + L, np.int32)  # lengths | codes | lane offsets
    host[:n_tab] = np.concatenate([c.lengths for c in codecs])
    host[n_tab + 1 : 2 * n_tab + 1] = np.concatenate(
        [c.codes.astype(np.uint32) for c in codecs]).view(np.int32)
    host[2 * (n_tab + 1) :] = np.cumsum(sizes) - sizes - 1  # the rank counts from 1
    tab = torch.from_numpy(host).to(dev)
    lens_tab, codes_tab, offsets = tab[: n_tab + 1], tab[n_tab + 1 : 2 * (n_tab + 1)], tab[-L:]
    idx[:, :n] += offsets[:, None]
    idx[:, n:] = n_tab
    return codecs, lens_tab[idx].view(L * C, cs), codes_tab[idx].view(L * C, cs)


_CODEC_CACHE: dict[bytes, HuffmanCodec] = {}
_CODEC_LOCK = threading.Lock()


def _cached_codec(table: bytes, device=None) -> HuffmanCodec:
    """Decode-side codec cache: repeated decodes of one artifact skip the
    canonical-table, LUT and device-table rebuilds.  A miss with a
    ``device`` builds the decode tables there at once (span ``lane.tables``,
    attribute ``hit``)."""
    with obs.span("lane.tables") as sp:
        with _CODEC_LOCK:
            codec = _CODEC_CACHE.get(table)
        sp.set(hit=codec is not None)
        if codec is None:
            codec, _ = HuffmanCodec.from_table(table)
            if device is not None and codec.alphabet.size:
                codec._tables_on(device)
            with _CODEC_LOCK:
                if len(_CODEC_CACHE) >= 16:
                    _CODEC_CACHE.pop(next(iter(_CODEC_CACHE)))
                _CODEC_CACHE[table] = codec
    return codec


def parse_chunked(blob, device=None):
    """Split an ``hc``/``hZ`` blob: (codec, n symbols, chunk size, chunk_bits,
    stream bytes, total bits); a codec missing from the cache is built with
    its decode tables on ``device`` when one is given."""
    n, cs, n_chunks, tlen = struct.unpack_from("<QIII", blob, 6)
    off = 6 + 20
    codec = _cached_codec(bytes(blob[off : off + tlen]), device)
    off += tlen
    (total,) = struct.unpack_from("<Q", blob, off)
    off += 8
    payload = blob[off:]
    if bytes(blob[4:6]) == b"hZ":
        with obs.span("lane.inflate"):
            payload = zlib.decompress(payload)
    cb_dtype = _chunk_bits_dtype(cs)
    chunk_bits = np.frombuffer(payload, cb_dtype, n_chunks)
    stream = bytes(payload[np.dtype(cb_dtype).itemsize * n_chunks :])
    return codec, n, cs, chunk_bits, stream, total


def encode_codes_legacy(codes: torch.Tensor, backend: str = "huffman+zlib") -> bytes:
    """The seed (pre-chunking) encoder: an ``hf``/``hz`` blob, byte-identical
    to the reference's.  A legacy stream's bits are the chunked stream's
    spliced bits (both MSB-first), so the fit (``symbol_hist``) and pack
    (``huffman_encode``) run on the codes' device as for ``hc``/``hZ``; only
    the framing differs: the bit count, the stream, no chunk table."""
    flat = codes.reshape(-1).to(torch.int32)
    if backend not in ("huffman", "huffman+zlib"):
        raise ValueError(f"legacy encoder only supports huffman backends, got {backend!r}")
    codec = HuffmanCodec.fit(flat)
    stream, total = b"", 0
    if flat.numel():
        stream, _bits, total = codec._device_pack(flat, DEFAULT_CHUNK)
    body = struct.pack("<Q", total) + stream
    if backend == "huffman+zlib":
        body = zlib.compress(body, 6)
        tag = b"hz"
    else:
        tag = b"hf"
    table = codec.table_bytes()
    return _MAGIC + tag + struct.pack("<QI", flat.numel(), len(table)) + table + body


def decode_codes(blob: bytes, shape: tuple[int, ...], *, device) -> torch.Tensor:
    """Decode an entropy blob back to int32 codes of ``shape`` on ``device``."""
    if bytes(blob[:4]) != _MAGIC:
        raise ValueError("bad entropy blob magic")
    device = torch.device(device)
    tag = bytes(blob[4:6])
    if tag in (b"z2", b"z4"):
        with obs.span("lane.inflate"):
            raw = zlib.decompress(blob[14:])
        dt = np.int16 if tag == b"z2" else np.int32
        out = torch.from_numpy(np.frombuffer(raw, dt).astype(np.int32))
        return out.to(device).reshape(shape)
    if tag in (b"hc", b"hZ"):
        codec, n, cs, chunk_bits, stream, total = parse_chunked(blob, device)
        out = codec.decode_chunked_device(stream, n, cs, chunk_bits,
                                          total_bits=total, device=device)
        return out.reshape(shape)
    if tag in (b"hf", b"hz"):
        n, tlen = struct.unpack_from("<QI", blob, 6)
        off = 6 + 12
        codec = _cached_codec(bytes(blob[off : off + tlen]), device)
        body = blob[off + tlen :]
        if tag == b"hz":
            with obs.span("lane.inflate"):
                body = zlib.decompress(body)
        return codec.decode_bitwalk(body, n, device=device).reshape(shape)
    raise ValueError(f"unknown entropy tag {tag!r}")


def decode_codes_range(blob: bytes, lo: int, hi: int, *, device) -> torch.Tensor:
    """Symbols ``[lo, hi)`` of an entropy blob as flat int32 on ``device``:
    equal to ``decode_codes(blob, (-1,), device=device)[lo:hi]``.

    On ``hc``/``hZ`` a partial read: only the chunks covering the range are
    uploaded and decoded (``hZ`` still pays one zlib pass over the lane); the
    other tags decode whole and are sliced.  A range outside ``[0, n)``
    raises ``ValueError``."""
    if bytes(blob[:4]) != _MAGIC:
        raise ValueError("bad entropy blob magic")
    device = torch.device(device)
    if bytes(blob[4:6]) in (b"hc", b"hZ"):
        (n,) = struct.unpack_from("<Q", blob, 6)
        if not 0 <= lo <= hi <= n:
            raise ValueError(f"symbol range [{lo}, {hi}) outside [0, {n})")
        if lo == hi:
            return torch.zeros(0, dtype=torch.int32, device=device)
        codec, n, cs, chunk_bits, stream, total = parse_chunked(blob, device)
        c0, c1 = lo // cs, -(-hi // cs)
        out = codec.decode_chunked_device(stream, n, cs, chunk_bits, total_bits=total,
                                          device=device, chunk_range=(c0, c1))
        return out[lo - c0 * cs : hi - c0 * cs]
    flat = decode_codes(blob, (-1,), device=device)
    if not 0 <= lo <= hi <= flat.numel():
        raise ValueError(f"symbol range [{lo}, {hi}) outside [0, {flat.numel()})")
    return flat[lo:hi]
