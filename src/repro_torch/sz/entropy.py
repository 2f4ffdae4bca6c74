"""Entropy stage: chunked canonical Huffman + zlib (port of
``repro/sz/entropy.py``; blob layout in docs/ENTROPY_FORMAT.md).

Split between host and device:

* on the device (the tensor's own: CUDA kernels on the card, their plain
  PyTorch versions on the CPU) -- the symbol histogram of ``fit``, the
  chunk-parallel encode pack and the multi-symbol LUT decode;
* on the host, as numpy -- the Huffman tree (``_code_lengths``), canonical
  codes, decode tables, the splice of packed chunks into one stream
  (``_splice_chunks``), zlib and the blob framing.

Blobs are byte-identical to the reference's for the ``z2``/``z4`` (zlib)
and ``hc``/``hZ`` (chunked Huffman) tags.  The per-symbol work never leaves
the symbols' device: what the kernels cannot take is refused with a
``ValueError`` on every device -- a table with a code longer than 32 bits
(no encoder writes one), a chunk larger than the encode kernel's shared
memory (:data:`MAX_CHUNK`) or a stream past int32 bit positions.  The
legacy ``hf``/``hz`` tags are not read yet.
"""
from __future__ import annotations

import heapq
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.huffman_encode import MAX_CHUNK
from repro_torch.sz.artifact import ENTROPY_MAGIC

_MAGIC = ENTROPY_MAGIC

DEFAULT_CHUNK = 256  # symbols per independently decodable chunk
_LUT_BITS = 12  # primary decode-table width cap (2**k entries)
_FMT_CODE_LEN = 32  # FROZEN in the hc/hZ blob format (chunk-table width rule)
_MAX_CODE_LEN = _FMT_CODE_LEN  # encoder policy; must never exceed _FMT_CODE_LEN
_DENSE_SPAN = 1 << 22  # wider alphabets are counted by torch.unique


def _chunk_bits_dtype(chunk_size: int) -> str:
    """Chunk-table entry width: u16 whenever a full chunk of max-length codes
    fits (wire format, pinned to the frozen ``_FMT_CODE_LEN``)."""
    return "<u2" if chunk_size * _FMT_CODE_LEN <= 0xFFFF else "<u4"


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
            raise ValueError(f"corrupt Huffman table: a {int(self.lengths.max())}-bit "
                             f"code (the format caps codes at {_FMT_CODE_LEN} bits)")

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
        words, chunk_bits = ops.huffman_encode_op(*self._pack_inputs(flat, chunk_size))
        bits = chunk_bits.cpu().numpy().astype(np.int64)
        used = -(-int(bits.max()) // 32)  # words past the widest chunk are zero
        local = words[:, :used].contiguous().cpu().numpy().view(np.uint32)
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
        """``_device_tables`` plus the alphabet as tensors on ``device``
        (cached per device; building twice under a race is harmless)."""
        per_dev = self.__dict__.setdefault("_dev_tensors", {})
        key = str(device)
        got = per_dev.get(key)
        if got is None:
            host = dict(self._device_tables())
            k = host.pop("k")
            got = {name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for name, a in host.items()}
            got["alphabet"] = torch.from_numpy(self.alphabet.astype(np.int32)).to(device)
            got["k"] = k
            per_dev[key] = got
        return got

    # -- decode -------------------------------------------------------------------
    def decode_chunked_device(self, stream: bytes, n_symbols: int, chunk_size: int,
                              chunk_bits: np.ndarray, *, total_bits: int | None,
                              device: torch.device) -> torch.Tensor:
        """Decode a chunked stream on ``device``; returns int32 symbols."""
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
        # the decode kernel holds bit positions in int32
        if total >= 1 << 31 or chunk_size * _FMT_CODE_LEN >= 1 << 31:
            raise ValueError(f"Huffman stream of {total} bits in chunks of {chunk_size} "
                             "is past the decoder's int32 bit positions")
        args, kw = self._decode_inputs(stream, n_symbols, chunk_size, ends - chunk_bits,
                                       device)
        ids = ops.huffman_decode_op(*args, **kw)
        # only the last chunk can be short, so row-major flatten + truncate
        # is exactly the symbol stream
        return self._tables_on(device)["alphabet"][ids.reshape(-1)[:n_symbols]]

    def _decode_inputs(self, stream: bytes, n_symbols: int, chunk_size: int,
                       offsets: np.ndarray, device: torch.device):
        """The decode kernel's arguments on ``device``: (words, offsets,
        counts, six tables) and (chunk_size, k)."""
        tabs = self._tables_on(device)
        C = offsets.size
        counts = np.full(C, chunk_size, np.int32)
        counts[-1] = n_symbols - chunk_size * (C - 1)
        raw = np.frombuffer(stream, np.uint8)
        # pad to a word boundary + 2 zero tail words for the wi+1 gather
        padded = np.zeros(raw.size + (-raw.size) % 4 + 8, np.uint8)
        padded[: raw.size] = raw
        words = padded.view(">u4").astype(np.uint32).view(np.int32)
        args = (torch.from_numpy(words).to(device),
                torch.from_numpy(offsets.astype(np.int32)).to(device),
                torch.from_numpy(counts).to(device), tabs["lut_count"], tabs["lut_bits"],
                tabs["lut_ids"], tabs["cw_map"], tabs["order"], tabs["len_sorted"])
        return args, {"chunk_size": chunk_size, "k": tabs["k"]}

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


def encode_codes(codes: torch.Tensor, backend: str = "huffman+zlib", *,
                 chunk_size: int | None = None) -> bytes:
    """Entropy-encode an int32 code tensor into a self-describing blob
    (``z2``/``z4`` for zlib, ``hc``/``hZ`` for the Huffman backends)."""
    flat = codes.reshape(-1).to(torch.int32)
    if backend == "zlib":
        host = flat.cpu().numpy()
        # int32 -> int16 when it fits (usual case): halves the zlib input
        if host.size and abs(host).max(initial=0) < 2**15:
            payload = zlib.compress(host.astype(np.int16).tobytes(), 6)
            tag = b"z2"
        else:
            payload = zlib.compress(host.tobytes(), 6)
            tag = b"z4"
        return _MAGIC + tag + struct.pack("<Q", host.size) + payload
    if backend in ("huffman", "huffman+zlib"):
        codec = HuffmanCodec.fit(flat)
        cs = int(chunk_size) if chunk_size else DEFAULT_CHUNK
        if not 0 < cs <= MAX_CHUNK:
            raise ValueError(f"chunk size {cs} outside 1..{MAX_CHUNK} (one chunk's "
                             "words must fit the encode kernel's shared memory)")
        n = flat.numel()
        n_chunks = -(-n // cs) if n else 0
        stream, chunk_bits, total = (codec._device_pack(flat, cs) if n_chunks
                                     else (b"", np.zeros(0, np.int64), 0))
        # chunk table + bit stream travel together so zlib sees both
        payload = chunk_bits.astype(_chunk_bits_dtype(cs)).tobytes() + stream
        if backend == "huffman+zlib":
            payload = zlib.compress(payload, 6)
            tag = b"hZ"
        else:
            tag = b"hc"
        table = codec.table_bytes()
        return (_MAGIC + tag + struct.pack("<QIII", n, cs, n_chunks, len(table))
                + table + struct.pack("<Q", total) + payload)
    raise ValueError(f"unknown entropy backend {backend!r}")


_CODEC_CACHE: dict[bytes, HuffmanCodec] = {}
_CODEC_LOCK = threading.Lock()


def _cached_codec(table: bytes) -> HuffmanCodec:
    """Decode-side codec cache: repeated decodes of one artifact skip the
    canonical-table, LUT and device-table rebuilds."""
    with _CODEC_LOCK:
        codec = _CODEC_CACHE.get(table)
    if codec is None:
        codec, _ = HuffmanCodec.from_table(table)
        with _CODEC_LOCK:
            if len(_CODEC_CACHE) >= 16:
                _CODEC_CACHE.pop(next(iter(_CODEC_CACHE)))
            _CODEC_CACHE[table] = codec
    return codec


def parse_chunked(blob):
    """Split an ``hc``/``hZ`` blob: (codec, n symbols, chunk size, chunk_bits,
    stream bytes, total bits)."""
    n, cs, n_chunks, tlen = struct.unpack_from("<QIII", blob, 6)
    off = 6 + 20
    codec = _cached_codec(bytes(blob[off : off + tlen]))
    off += tlen
    (total,) = struct.unpack_from("<Q", blob, off)
    off += 8
    payload = blob[off:]
    if bytes(blob[4:6]) == b"hZ":
        payload = zlib.decompress(payload)
    cb_dtype = _chunk_bits_dtype(cs)
    chunk_bits = np.frombuffer(payload, cb_dtype, n_chunks)
    stream = bytes(payload[np.dtype(cb_dtype).itemsize * n_chunks :])
    return codec, n, cs, chunk_bits, stream, total


def decode_codes(blob: bytes, shape: tuple[int, ...], *, device) -> torch.Tensor:
    """Decode an entropy blob back to int32 codes of ``shape`` on ``device``."""
    if bytes(blob[:4]) != _MAGIC:
        raise ValueError("bad entropy blob magic")
    device = torch.device(device)
    tag = bytes(blob[4:6])
    if tag in (b"z2", b"z4"):
        raw = zlib.decompress(blob[14:])
        dt = np.int16 if tag == b"z2" else np.int32
        out = torch.from_numpy(np.frombuffer(raw, dt).astype(np.int32))
        return out.to(device).reshape(shape)
    if tag in (b"hc", b"hZ"):
        codec, n, cs, chunk_bits, stream, total = parse_chunked(blob)
        out = codec.decode_chunked_device(stream, n, cs, chunk_bits,
                                          total_bits=total, device=device)
        return out.reshape(shape)
    raise ValueError(f"unsupported entropy tag {tag!r} (legacy hf/hz blobs are "
                     "not read by this package yet)")
