"""Append-only ``GWTC`` v3 writer (port of the in-memory half of
``repro/exec/writer.py::GWTCWriter``; layout in docs/TILED_FORMAT.md).

Header, shape and tile go out first, lanes are appended in row-major tile
order, and :meth:`GWTCWriter.finalize` writes the extras blob, the index
(u64 lane lengths | u32 lane CRC-32s | u32 metadata CRC) and the footer.
``TiledCompressed._serialize`` routes through it, so the bytes equal the
reference's eager and streamed containers.  The commit journal and
``resume`` of streaming ingest are not ported yet.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from repro_torch.sz import tiled as T
from repro_torch.sz.predictor import ORDER_IDS, PRED_IDS


class GWTCWriter:
    """Write one GWTC v3 container to ``dest`` (any object with ``write``)."""

    def __init__(self, dest, *, shape, tile, eb_abs: float,
                 backend: str = "huffman+zlib", predictor: str = "lorenzo",
                 order: str = "cubic", levels: int = 0):
        shape = tuple(int(d) for d in shape)
        tile = T.normalize_tile(tile, len(shape))
        self.n_tiles = int(np.prod(T.tile_grid(shape, tile)))
        self.extras: dict = {}
        self._dest = dest
        self._written = 0
        self._lens: list[int] = []
        self._crcs: list[int] = []
        self._finalized = False
        nd = len(shape)
        hdr = T._HDR_V3.pack(T._MAGIC, T._VERSION, nd, T._BACKENDS[backend],
                             PRED_IDS[predictor], ORDER_IDS[order], int(levels),
                             0, np.float64(eb_abs).view(np.uint64), self.n_tiles)
        self._prefix = hdr + struct.pack(f"<{nd}q", *shape) + struct.pack(f"<{nd}q", *tile)
        self._write(self._prefix)

    def _write(self, b: bytes) -> None:
        self._dest.write(b)
        self._written += len(b)

    def append_lane(self, lane) -> None:
        if self._finalized:
            raise ValueError("writer already finalized")
        if len(self._lens) >= self.n_tiles:
            raise ValueError(f"container holds {self.n_tiles} lanes; lane "
                             f"{len(self._lens)} does not fit")
        lane = bytes(lane)
        self._lens.append(len(lane))
        self._crcs.append(T.lane_crc(lane))
        self._write(lane)

    def finalize(self) -> int:
        """Write extras + index + footer; returns the container's size."""
        if self._finalized:
            raise ValueError("writer already finalized")
        if len(self._lens) != self.n_tiles:
            raise ValueError(f"container needs {self.n_tiles} lanes, got {len(self._lens)}")
        extras_off = self._written
        extras_blob = T._pack_extras(self.extras)
        self._write(extras_blob)
        index_off = self._written
        self._write(np.asarray(self._lens, np.uint64).tobytes())
        self._write(np.asarray(self._crcs, np.uint32).tobytes())
        meta_crc = zlib.crc32(extras_blob, zlib.crc32(self._prefix)) & 0xFFFFFFFF
        self._write(struct.pack("<I", meta_crc))
        self._write(T._FOOTER_V3.pack(extras_off, index_off))
        self._finalized = True
        return self._written
