"""Plain parser of the GWTC v3 container and of its lanes' entropy blobs.

Written from the format documents (``docs/TILED_FORMAT.md``,
``docs/ENTROPY_FORMAT.md``), not from the program: header, dims, lanes
located by the footer index, per-lane CRC-32s, extras; and an ``RPRE``
``hc``/``hZ``/``z2``/``z4`` blob split into its code table, chunk table and
bit stream.  Numpy and the standard library only.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

GWTC_MAGIC = b"GWTC"
ENTROPY_MAGIC = b"RPRE"
_HDR = struct.Struct("<4sBBBBBBBQQ")  # magic ver ndim backend pred order levels pad eb n
_FOOTER = struct.Struct("<QQ")
PREDICTORS = {0: "lorenzo", 1: "interp"}
ORDERS = {0: "linear", 1: "cubic"}


@dataclass
class Container:
    shape: tuple[int, ...]
    tile: tuple[int, ...]
    eb_abs: float
    predictor: str
    order: str
    levels: int
    lanes: list[bytes]
    crc_bad: int  # lanes whose bytes disagree with the index CRC-32
    extras: dict = field(default_factory=dict)

    @property
    def grid(self) -> tuple[int, ...]:
        return tuple(-(-d // t) for d, t in zip(self.shape, self.tile))


def parse_gwtc(blob: bytes) -> Container:
    """A GWTC v3 blob with its checksummed index."""
    (magic, ver, nd, _backend, pred, order, levels, _pad, ebbits,
     n_tiles) = _HDR.unpack_from(blob, 0)
    if magic != GWTC_MAGIC or ver != 3:
        raise ValueError(f"not a GWTC v3 container: {magic!r} v{ver}")
    off = _HDR.size
    shape = struct.unpack_from(f"<{nd}q", blob, off)
    tile = struct.unpack_from(f"<{nd}q", blob, off + 8 * nd)
    lanes_start = off + 16 * nd
    extras_off, index_off = _FOOTER.unpack_from(blob, len(blob) - _FOOTER.size)
    if len(blob) - _FOOTER.size - index_off != 12 * n_tiles + 4:
        raise ValueError("GWTC index without lane checksums")
    lens = np.frombuffer(blob, np.uint64, n_tiles, offset=index_off).astype(np.int64)
    crcs = np.frombuffer(blob, np.uint32, n_tiles, offset=index_off + 8 * n_tiles)
    offs = lanes_start + np.concatenate([[0], np.cumsum(lens)[:-1]])
    if lanes_start + int(lens.sum()) != extras_off:
        raise ValueError("GWTC lane lengths do not add up to the extras offset")
    lanes = [blob[o:o + n] for o, n in zip(offs.tolist(), lens.tolist())]
    crc_bad = sum(int(zlib.crc32(b) & 0xFFFFFFFF != int(c)) for b, c in zip(lanes, crcs))
    extras = {}
    (count,) = struct.unpack_from("<I", blob, extras_off)
    p = extras_off + 4
    for _ in range(count):
        klen, vlen = struct.unpack_from("<II", blob, p)
        p += 8
        key = blob[p:p + klen].decode()
        extras[key] = blob[p + klen:p + klen + vlen]
        p += klen + vlen
    return Container(tuple(shape), tuple(tile), float(np.uint64(ebbits).view(np.float64)),
                     PREDICTORS[pred], ORDERS[order], int(levels), lanes, crc_bad, extras)


@dataclass
class HuffmanLane:
    """One ``hc``/``hZ`` blob: its canonical code and its chunked stream."""

    n: int  # symbols
    chunk: int  # symbols a chunk
    alphabet: np.ndarray  # int32 symbol values
    lengths: np.ndarray  # code length of each alphabet entry
    chunk_bits: np.ndarray  # int64 bits of each chunk
    stream: bytes  # MSB-first bit stream of all chunks back to back


def parse_entropy(blob: bytes):
    """An entropy blob -> ``HuffmanLane``, or an int32 array for ``z2``/``z4``."""
    if blob[:4] != ENTROPY_MAGIC:
        raise ValueError("bad entropy blob magic")
    tag = blob[4:6]
    if tag in (b"z2", b"z4"):
        raw = zlib.decompress(blob[14:])
        return np.frombuffer(raw, np.int16 if tag == b"z2" else np.int32).astype(np.int32)
    if tag not in (b"hc", b"hZ"):
        raise ValueError(f"unsupported entropy tag {tag!r}")
    n, cs, n_chunks, tlen = struct.unpack_from("<QIII", blob, 6)
    p = 26
    (n_alpha,) = struct.unpack_from("<I", blob, p)
    alphabet = np.frombuffer(blob, np.int32, n_alpha, offset=p + 4).copy()
    lengths = np.frombuffer(blob, np.uint8, n_alpha, offset=p + 4 + 4 * n_alpha).astype(np.int64)
    p += tlen
    (total,) = struct.unpack_from("<Q", blob, p)
    payload = blob[p + 8:]
    if tag == b"hZ":
        payload = zlib.decompress(payload)
    cb_dtype = np.dtype("<u2") if cs * 32 <= 0xFFFF else np.dtype("<u4")
    chunk_bits = np.frombuffer(payload, cb_dtype, n_chunks).astype(np.int64)
    if int(chunk_bits.sum()) != total:
        raise ValueError("chunk table disagrees with the stream's bit count")
    stream = bytes(payload[cb_dtype.itemsize * n_chunks:])
    return HuffmanLane(int(n), int(cs), alphabet, lengths, chunk_bits, stream)
