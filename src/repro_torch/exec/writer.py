"""Incremental, append-only container writers, port of
``repro/exec/writer.py`` (layouts in docs/TILED_FORMAT.md and
docs/DATASET_FORMAT.md).

Both writers emit *footer-indexed* layouts.  :class:`GWTCWriter` writes
header, shape and tile first, appends lanes in row-major tile order, and
:meth:`GWTCWriter.finalize` writes the extras blob, the index (u64 lane
lengths | u32 lane CRC-32s | u32 metadata CRC) and the footer;
:class:`GWDSWriter` appends named field blobs and writes the name index as
a footer.  Nothing is buffered and nothing is seeked backwards, so a
stream can be written through a pipe as well as a file.
``TiledCompressed._serialize`` and ``api.Dataset.build`` route through
these writers, so eager and streamed bytes are identical, and both equal
the reference's.

Fault tolerance (docs/ROBUSTNESS.md): when the destination is a *path*,
the writer keeps a sidecar commit journal (``<path>.journal``), in the
reference's byte layout.  :meth:`GWTCWriter.commit` durably records the
lanes appended so far (the data file is fsync'd *before* the journal block
lands, so a journaled lane is always really on disk),
:meth:`GWTCWriter.rollback_uncommitted` truncates a half-appended batch
away so it can be retried, and :meth:`GWTCWriter.resume` re-opens an
interrupted container at its last committed byte.  :meth:`finalize`
removes the journal: a surviving journal file is exactly the marker of an
interrupted stream.  A ``GWTCWriter`` that streams a field into a GWDS
envelope (:meth:`GWDSWriter.stream_field`) shares the envelope's sink: it
writes no journal and cannot roll back (``can_rollback`` is False), so the
streaming executor appends each batch once there and fails fast.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from repro_torch.errors import CorruptContainerError
from repro_torch.sz import artifact as A
from repro_torch.sz import tiled as T
from repro_torch.sz.predictor import ORDER_IDS, ORDER_NAMES, PRED_IDS, PRED_NAMES

# GWDS header: magic, version, pad x3, u32 (v1: the field count; v2:
# reserved, the count lives in the footer: it is not known when a streaming
# writer starts)
_GWDS_HDR = struct.Struct("<4sB3xI")
# GWDS index entry, after its u32 name length and name: field offset, length
_GWDS_ENTRY = struct.Struct("<QQ")
# GWDS v2 footer: index offset, field count, sentinel
_GWDS_FOOTER = struct.Struct("<QI4s")

# --- commit journal (sidecar <path>.journal) --------------------------------
# header:  magic 'GWJL', version, pad, prefix_len u32, prefix bytes, crc u32
#          (prefix = the container's header|shape|tile bytes, so resume can
#          verify it is appending to the stream it thinks it is)
# blocks:  n_new u32 | n_new x (lane_len u64, lane_crc u32) | committed u64
#          | block crc u32, one block per commit(); a torn tail block (crash
#          mid-append) fails its CRC and is ignored, the previous block wins.
_JOURNAL_HDR = struct.Struct("<4sB3xI")
_LANE_ENTRY = struct.Struct("<QI")


def journal_path(path) -> str:
    return os.fspath(path) + ".journal"


def _journal_head(prefix: bytes) -> bytes:
    return (_JOURNAL_HDR.pack(A.JOURNAL_MAGIC, A.JOURNAL_VERSION, len(prefix)) + prefix
            + struct.pack("<I", zlib.crc32(prefix) & 0xFFFFFFFF))


def _read_journal(jpath):
    """Parse a commit journal -> (prefix, lens, crcs, committed_bytes).

    Walks commit blocks until EOF or the first torn/corrupt block; the
    state as of the last intact block is returned.  Raises
    :class:`CorruptContainerError` when the journal itself is unusable."""
    with open(jpath, "rb") as f:
        blob = f.read()
    try:
        magic, ver, prefix_len = _JOURNAL_HDR.unpack_from(blob, 0)
    except struct.error as e:
        raise CorruptContainerError(f"truncated commit journal {jpath}: {e}", offset=0) from e
    if magic != A.JOURNAL_MAGIC or ver != A.JOURNAL_VERSION:
        raise CorruptContainerError(
            "bad commit journal header", offset=0,
            expected=(A.JOURNAL_MAGIC, A.JOURNAL_VERSION), actual=(bytes(magic), int(ver)))
    off = _JOURNAL_HDR.size
    prefix = blob[off : off + prefix_len]
    off += prefix_len
    try:
        (pcrc,) = struct.unpack_from("<I", blob, off)
    except struct.error as e:
        raise CorruptContainerError(
            f"truncated commit journal {jpath} (no prefix crc)", offset=off) from e
    off += 4
    if len(prefix) != prefix_len or zlib.crc32(prefix) & 0xFFFFFFFF != pcrc:
        raise CorruptContainerError(
            "commit journal prefix failed its checksum", offset=_JOURNAL_HDR.size)
    lens: list[int] = []
    crcs: list[int] = []
    committed = len(prefix)
    while off < len(blob):
        block_start = off
        try:
            (n_new,) = struct.unpack_from("<I", blob, off)
            off += 4
            entries = [_LANE_ENTRY.unpack_from(blob, off + i * _LANE_ENTRY.size)
                       for i in range(n_new)]
            off += n_new * _LANE_ENTRY.size
            (total,) = struct.unpack_from("<Q", blob, off)
            off += 8
            (bcrc,) = struct.unpack_from("<I", blob, off)
            off += 4
        except struct.error:
            break  # torn tail block from a crash mid-append: previous wins
        if zlib.crc32(blob[block_start : off - 4]) & 0xFFFFFFFF != bcrc:
            break
        lens.extend(int(ln) for ln, _c in entries)
        crcs.extend(int(c) for _ln, c in entries)
        committed = int(total)
    return bytes(prefix), lens, crcs, committed


class _Dest:
    """Append-only byte sink over a path or file-like; tracks bytes written
    from the start of the sink (a ``GWTC`` container embedded as a GWDS
    field takes its container-relative footer offsets from a base mark)."""

    def __init__(self, dest, *, own: bool | None = None):
        if hasattr(dest, "write"):
            self._f = dest
            self._own = bool(own)
        else:
            self._f = open(os.fspath(dest), "wb")
            self._own = True
        self.written = 0

    def write(self, b) -> None:
        self._f.write(b)
        self.written += len(b)

    def fsync(self) -> None:
        """Flush to the OS and (for real files) to the device: called
        before a journal commit so committed lanes are durably on disk."""
        self._f.flush()
        try:
            os.fsync(self._f.fileno())
        except (OSError, AttributeError):
            pass  # BytesIO / pipes: flush is all the durability there is

    def truncate(self, n: int) -> None:
        """Drop everything past byte ``n`` and reposition: the rollback
        primitive for retrying a half-appended batch."""
        self._f.flush()
        self._f.truncate(n)
        self._f.seek(n)
        self.written = n

    def close(self) -> None:
        if self._own:
            self._f.close()


class GWTCWriter:
    """Streaming ``GWTC`` v3 writer: header up front, lanes appended in
    row-major tile order, extras + index + footer on :meth:`finalize`.

    The tile geometry (and therefore the lane count) is fixed at
    construction; :meth:`finalize` refuses a partial container.  ``extras``
    is a plain dict: attach entries (e.g. a trained GWLZ model under
    ``"gwlz"``) any time before finalize.

    ``dest`` is a path, a writable file object, or a GWDS envelope's shared
    sink (a :class:`_Dest`, from :meth:`GWDSWriter.stream_field`).  Path
    destinations are *journaled*: each :meth:`commit` fsyncs the data file,
    then appends a checksummed block to ``<path>.journal``, making the
    committed prefix durable and :meth:`resume`-able; :meth:`finalize`
    deletes the journal.  File objects get no journal but still track the
    commit point, so :meth:`rollback_uncommitted` works wherever they
    truncate.  A shared sink gets no journal and no rollback; footer
    offsets stay container-relative through the sink's byte count at
    construction (``_base``).  ``on_finalize(total_bytes)`` runs after the
    footer is written."""

    def __init__(self, dest, *, shape, tile, eb_abs: float,
                 backend: str = "huffman+zlib", predictor: str = "lorenzo",
                 order: str = "cubic", levels: int = 0, on_finalize=None):
        shape = tuple(int(d) for d in shape)
        tile = T.normalize_tile(tile, len(shape))
        self.shape, self.tile = shape, tile
        self.n_tiles = int(np.prod(T.tile_grid(shape, tile)))
        self.eb_abs = float(eb_abs)
        self.backend, self.predictor = backend, predictor
        self.order, self.levels = order, int(levels)
        self.extras: dict = {}
        self._lens: list[int] = []
        self._crcs: list[int] = []
        self._on_finalize = on_finalize
        self._shared = isinstance(dest, _Dest)
        is_path = not self._shared and not hasattr(dest, "write")
        self._journal_path = journal_path(dest) if is_path else None
        self._journal_f = None
        self._dest = dest if self._shared else _Dest(dest)
        self._base = self._dest.written
        self._finalized = False
        nd = len(shape)
        hdr = T._HDR_V3.pack(T._MAGIC, T._VERSION, nd, T._BACKENDS[backend],
                             PRED_IDS[predictor], ORDER_IDS[order], int(levels),
                             0, np.float64(self.eb_abs).view(np.uint64), self.n_tiles)
        self._prefix = hdr + struct.pack(f"<{nd}q", *shape) + struct.pack(f"<{nd}q", *tile)
        self._dest.write(self._prefix)
        # everything up to and including the fixed prefix counts as committed
        self._committed_lanes = 0
        self._committed_bytes = len(self._prefix)
        if self._journal_path is not None:
            self._journal_f = open(self._journal_path, "wb")
            self._journal_f.write(_journal_head(self._prefix))
            self._journal_f.flush()

    @property
    def lanes_written(self) -> int:
        return len(self._lens)

    @property
    def committed_lanes(self) -> int:
        """Lanes durably recorded by the last :meth:`commit`: a resumed
        stream restarts from exactly this point."""
        return self._committed_lanes

    @property
    def can_rollback(self) -> bool:
        """Whether :meth:`rollback_uncommitted` is available (owned sinks
        only: a shared GWDS envelope cannot be truncated mid-field)."""
        return not self._shared

    def append_lane(self, lane) -> None:
        if self._finalized:
            raise ValueError("writer already finalized")
        if len(self._lens) >= self.n_tiles:
            raise ValueError(f"container holds {self.n_tiles} lanes; lane "
                             f"{len(self._lens)} does not fit")
        lane = bytes(lane)
        self._lens.append(len(lane))
        self._crcs.append(T.lane_crc(lane))
        self._dest.write(lane)

    def commit(self) -> None:
        """Durably record every lane appended so far.

        Ordering matters: the data file is fsync'd *first*, then the journal
        block is appended, flushed and fsync'd, so a journal entry never
        refers to bytes that might not have reached the disk."""
        if self._finalized:
            raise ValueError("writer already finalized")
        n_new = len(self._lens) - self._committed_lanes
        if n_new <= 0:
            return
        self._dest.fsync()
        self._committed_lanes = len(self._lens)
        self._committed_bytes = len(self._prefix) + sum(self._lens)
        if self._journal_f is not None:
            block = struct.pack("<I", n_new)
            for i in range(self._committed_lanes - n_new, self._committed_lanes):
                block += _LANE_ENTRY.pack(self._lens[i], self._crcs[i])
            block += struct.pack("<Q", self._committed_bytes)
            block += struct.pack("<I", zlib.crc32(block) & 0xFFFFFFFF)
            self._journal_f.write(block)
            self._journal_f.flush()
            os.fsync(self._journal_f.fileno())

    def rollback_uncommitted(self) -> int:
        """Truncate everything after the last commit point (a half-appended
        batch being retried); returns the number of lanes dropped."""
        if self._finalized:
            raise ValueError("writer already finalized")
        if self._shared:
            raise ValueError("cannot roll back a writer on a shared sink")
        dropped = len(self._lens) - self._committed_lanes
        if dropped:
            del self._lens[self._committed_lanes:]
            del self._crcs[self._committed_lanes:]
            self._dest.truncate(self._committed_bytes)
        return dropped

    def truncate_lanes(self, n: int) -> None:
        """Shrink the *committed* stream to its first ``n`` lanes (resume
        alignment: a commit point mid-batch is rounded down to a batch
        boundary so the re-streamed batches reproduce the original bytes)."""
        if self._shared:
            raise ValueError("cannot truncate a writer on a shared sink")
        if not 0 <= n <= self._committed_lanes:
            raise ValueError(f"cannot truncate to {n} lanes; {self._committed_lanes} committed")
        del self._lens[n:]
        del self._crcs[n:]
        self._committed_lanes = n
        self._committed_bytes = len(self._prefix) + sum(self._lens)
        self._dest.truncate(self._committed_bytes)
        if self._journal_f is not None:
            # rewrite the journal from scratch: header + one block of the kept lanes
            self._journal_f.close()
            self._journal_f = open(self._journal_path, "wb")
            self._journal_f.write(_journal_head(self._prefix))
            self._journal_f.flush()
            self._committed_lanes = 0
            if n:
                self.commit()
            self._committed_lanes = n

    @classmethod
    def resume(cls, path) -> "GWTCWriter":
        """Re-open an interrupted journaled stream at its last commit point.

        Validates that the data file still begins with the journaled
        container prefix and holds at least the committed bytes, truncates
        any uncommitted tail, and returns a writer positioned to append
        lane ``committed_lanes`` next.  Raises
        :class:`CorruptContainerError` when the file and journal disagree."""
        jpath = journal_path(path)
        if not os.path.exists(jpath):
            raise FileNotFoundError(f"no commit journal at {jpath}; nothing to resume")
        prefix, lens, crcs, committed = _read_journal(jpath)
        (_m, _v, nd, backend, pred, order, levels, _pad, ebbits,
         _n_tiles) = T._HDR_V3.unpack_from(prefix, 0)
        shape = struct.unpack_from(f"<{nd}q", prefix, T._HDR_V3.size)
        tile = struct.unpack_from(f"<{nd}q", prefix, T._HDR_V3.size + 8 * nd)
        f = open(os.fspath(path), "r+b")
        try:
            head = f.read(len(prefix))
            if head != prefix:
                raise CorruptContainerError(
                    "container prefix does not match its commit journal "
                    "(wrong file, or header bytes were damaged)", offset=0)
            f.seek(0, 2)
            size = f.tell()
            if size < committed:
                raise CorruptContainerError(
                    "container is shorter than its journaled commit point",
                    offset=size, expected=f">= {committed} bytes", actual=size)
        except BaseException:
            f.close()
            raise
        f.truncate(committed)
        f.seek(committed)
        self = cls.__new__(cls)
        self.shape, self.tile = tuple(map(int, shape)), tuple(map(int, tile))
        self.n_tiles = int(np.prod(T.tile_grid(self.shape, self.tile)))
        self.eb_abs = float(np.uint64(ebbits).view(np.float64))
        self.backend = T._BACKENDS_INV[backend]
        self.predictor, self.order = PRED_NAMES[pred], ORDER_NAMES[order]
        self.levels = int(levels)
        self.extras = {}
        self._lens, self._crcs = list(lens), list(crcs)
        self._on_finalize = None
        self._shared = False
        self._journal_path = jpath
        self._journal_f = open(jpath, "ab")
        self._dest = _Dest(f, own=True)
        self._dest.written = committed
        self._base = 0
        self._finalized = False
        self._prefix = prefix
        self._committed_lanes = len(lens)
        self._committed_bytes = committed
        return self

    def finalize(self) -> int:
        """Write extras + index (lens | lane CRCs | metadata CRC) + footer;
        removes the commit journal; returns the container's size."""
        if self._finalized:
            raise ValueError("writer already finalized")
        if len(self._lens) != self.n_tiles:
            raise ValueError(f"container needs {self.n_tiles} lanes, got {len(self._lens)}")
        extras_off = self._dest.written - self._base
        extras_blob = T._pack_extras(self.extras)
        self._dest.write(extras_blob)
        index_off = self._dest.written - self._base
        self._dest.write(np.asarray(self._lens, np.uint64).tobytes())
        self._dest.write(np.asarray(self._crcs, np.uint32).tobytes())
        meta_crc = zlib.crc32(extras_blob, zlib.crc32(self._prefix)) & 0xFFFFFFFF
        self._dest.write(struct.pack("<I", meta_crc))
        self._dest.write(T._FOOTER_V3.pack(extras_off, index_off))
        self._finalized = True
        total = self._dest.written - self._base
        if not self._shared:
            self._dest.close()
        if self._journal_f is not None:
            self._journal_f.close()
            self._journal_f = None
            os.unlink(self._journal_path)
        if self._on_finalize is not None:
            self._on_finalize(total)
        return total

    def abort(self) -> None:
        """Give up on a partial container: close the sink (when owned)
        without writing a footer.  The bytes on disk are unreadable by
        design (a missing footer is how a truncated stream is detected).
        A journaled writer keeps its journal: the pair stays resumable."""
        if self._journal_f is not None:
            self._journal_f.close()
            self._journal_f = None
        if not self._finalized and not self._shared:
            self._dest.close()

    def __enter__(self) -> "GWTCWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None and not self._finalized:
            self.finalize()
        elif exc_type is not None:
            self.abort()


class GWDSWriter:
    """Streaming multi-field ``GWDS`` v2 writer.

    Fields are appended one at a time, either whole (:meth:`add_field` with
    a volume, an artifact or bytes) or streamed in place
    (:meth:`stream_field` returns a :class:`GWTCWriter` that writes the
    field's lanes straight into the envelope), so a many-field snapshot
    never needs two fields in memory at once.  The name index is written
    as a footer on :meth:`finalize`."""

    def __init__(self, dest):
        self._dest = _Dest(dest)
        self._index: list[tuple[str, int, int]] = []  # (name, offset, length)
        self._names: set[str] = set()
        self._streaming: str | None = None
        self._finalized = False
        self._dest.write(_GWDS_HDR.pack(A.GWDS_MAGIC, A.GWDS_VERSION, 0))

    def _begin(self, name: str) -> int:
        if self._finalized:
            raise ValueError("writer already finalized")
        if self._streaming is not None:
            raise ValueError(f"field {self._streaming!r} is still streaming; finalize it first")
        if name in self._names:
            raise ValueError(f"duplicate GWDS field {name!r}")
        return self._dest.written

    def _end(self, name: str, off: int, length: int) -> None:
        self._index.append((name, off, length))
        self._names.add(name)

    def add_field(self, name: str, obj) -> None:
        """Append one complete field (CompressedVolume, artifact, or bytes)."""
        off = self._begin(name)
        blob = obj if isinstance(obj, (bytes, bytearray, memoryview)) else obj.to_bytes()
        self._dest.write(bytes(blob))
        self._end(name, off, self._dest.written - off)

    def stream_field(self, name: str, **gwtc_kwargs) -> GWTCWriter:
        """Open a :class:`GWTCWriter` that streams one tiled field straight
        into the envelope (pass it to ``stream_compress`` as ``dest``); the
        field is recorded when that writer finalizes."""
        off = self._begin(name)
        self._streaming = name

        def done(total: int) -> None:
            self._streaming = None
            self._end(name, off, total)

        return GWTCWriter(self._dest, on_finalize=done, **gwtc_kwargs)

    def finalize(self) -> int:
        """Write the index and footer; returns the envelope's size."""
        if self._finalized:
            raise ValueError("writer already finalized")
        if self._streaming is not None:
            raise ValueError(f"field {self._streaming!r} is still streaming")
        if not self._index:
            raise ValueError("a GWDS dataset needs at least one field")
        index_off = self._dest.written
        for name, off, length in self._index:
            nb = name.encode()
            self._dest.write(struct.pack("<I", len(nb)) + nb + _GWDS_ENTRY.pack(off, length))
        self._dest.write(_GWDS_FOOTER.pack(index_off, len(self._index), A.GWDS_SENTINEL))
        self._finalized = True
        total = self._dest.written
        self._dest.close()
        return total

    def __enter__(self) -> "GWDSWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None and not self._finalized:
            self.finalize()
        elif exc_type is not None:
            self._dest.close()


def _read_gwds_index(blob, off: int, n_fields: int, limit: int,
                     region: str) -> dict[str, tuple[int, int]]:
    """``n_fields`` index entries from ``off``: name -> (offset, length).  A
    field that ends past ``limit`` (the end of the ``region``) is corrupt."""
    index: dict[str, tuple[int, int]] = {}
    for _ in range(n_fields):
        (nlen,) = struct.unpack_from("<I", blob, off)
        off += 4
        name = bytes(blob[off : off + nlen]).decode()
        off += nlen
        fo, fl = _GWDS_ENTRY.unpack_from(blob, off)
        off += _GWDS_ENTRY.size
        if fo + fl > limit:
            raise CorruptContainerError(
                f"GWDS field {name!r} extends past the {region}: truncated file?",
                offset=off - _GWDS_ENTRY.size, expected=f"<= {int(limit)}",
                actual=int(fo + fl))
        index[name] = (int(fo), int(fl))
    return index


def parse_gwds(blob) -> dict[str, tuple[int, int]]:
    """A ``GWDS`` envelope's index: name -> (offset, length).

    v1 keeps the index after the header and the field count in it; v2 (what
    :class:`GWDSWriter` writes) keeps both in the footer.  Accepts any buffer
    (bytes or a memoryview over an mmap); only the header, the footer and
    the index bytes are touched.  Damage raises ``CorruptContainerError``
    with the reference's messages."""
    try:
        magic, ver, n_fields = _GWDS_HDR.unpack_from(blob, 0)
        if magic != A.GWDS_MAGIC:
            raise CorruptContainerError("bad GWDS magic", offset=0, expected=A.GWDS_MAGIC,
                                        actual=bytes(magic))
        if ver == 1:
            return _read_gwds_index(blob, _GWDS_HDR.size, n_fields, len(blob), "blob")
        if ver != A.GWDS_VERSION:
            raise CorruptContainerError("unsupported GWDS version", offset=4,
                                        expected=(1, A.GWDS_VERSION), actual=int(ver))
    except struct.error as e:
        raise CorruptContainerError(f"truncated or corrupt GWDS envelope: {e}",
                                    offset=0) from e
    floor = _GWDS_HDR.size + _GWDS_FOOTER.size
    if len(blob) < floor:
        raise CorruptContainerError("truncated GWDS v2 envelope", offset=0,
                                    expected=f">= {floor} bytes", actual=len(blob))
    foot = len(blob) - _GWDS_FOOTER.size
    index_off, n_fields, sentinel = _GWDS_FOOTER.unpack_from(blob, foot)
    if sentinel != A.GWDS_SENTINEL:
        raise CorruptContainerError("truncated or corrupt GWDS v2 envelope (bad footer)",
                                    offset=len(blob) - 4, expected=A.GWDS_SENTINEL,
                                    actual=bytes(sentinel))
    if index_off > foot:
        raise CorruptContainerError("corrupt GWDS v2 envelope (index offset out of range)",
                                    offset=foot, expected=f"<= {foot}", actual=int(index_off))
    try:
        return _read_gwds_index(blob, index_off, n_fields, index_off, "payload")
    except struct.error as e:
        raise CorruptContainerError(f"truncated GWDS v2 index: {e}",
                                    offset=int(index_off)) from e
