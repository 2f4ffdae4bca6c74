"""Tile-based compression engine with random-access decode (``GWTC``), port
of ``repro/sz/tiled.py``.

The volume is edge-padded to a whole number of tiles and split; every tile
is an independent prediction domain and one independent entropy lane, and
the container's footer index locates each lane, so
:func:`decompress_region` entropy-decodes only the tiles an ROI touches.
Region decode is bit-identical to the full decode's crop: the Lorenzo decode
(an int32 cumsum and one multiply per element) never mixes tiles.

Device work (prequantize + Lorenzo, histogram, pack, decode, cumsum) runs on
the tensors' device; lane framing, zlib and CRCs on the host.  Containers
are byte-identical to the reference's (GWTC v3 written; v1, v2 and v3
read).  The XLA-oriented ``dispatch_bucketed`` has no counterpart: eager
PyTorch compiles nothing per batch size, so decode is one batched call.
"""
from __future__ import annotations

import io
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.errors import CorruptContainerError, CorruptLaneError
from repro_torch.kernels.ops import resolve_device
from repro_torch.sz import artifact as A
from repro_torch.sz.predictor import ORDER_IDS, ORDER_NAMES, PRED_IDS, PRED_NAMES, get_predictor
from repro_torch.sz.quantizer import resolve_eb

_MAGIC = A.GWTC_MAGIC
_VERSION = A.GWTC_VERSION
# v1: magic, version, ndim, backend, pad, eb bits, n_tiles
_HDR_V1 = struct.Struct("<4sBBBBQQ")
# v2/v3: magic, version, ndim, backend, predictor, order, levels, pad, eb bits,
# n_tiles.  v3 puts lanes right after the dims and the extras + index behind
# them, located by a fixed footer; the index is u64 lens[n] (pre-checksum) or
# u64 lens[n] | u32 crcs[n] | u32 meta_crc, told apart by its byte extent.
_HDR_V2 = struct.Struct("<4sBBBBBBBQQ")
_HDR_V3 = _HDR_V2
_FOOTER_V3 = struct.Struct("<QQ")  # (extras offset, index offset)
_BACKENDS = {"zlib": 0, "huffman": 1, "huffman+zlib": 2}
_BACKENDS_INV = {v: k for k, v in _BACKENDS.items()}


def lane_crc(data) -> int:
    """Container lane checksum: CRC-32 (IEEE 802.3, ``zlib.crc32``), as the
    reference writes it."""
    return zlib.crc32(bytes(data)) & 0xFFFFFFFF


def _pack_extras(extras: dict) -> bytes:
    """count u32, then per entry klen u32 | vlen u32 | key | value, sorted."""
    items = sorted(extras.items())
    out = [struct.pack("<I", len(items))]
    for k, v in items:
        kb = k.encode()
        out.append(struct.pack("<II", len(kb), len(v)) + kb + bytes(v))
    return b"".join(out)


def _unpack_extras(blob, off: int) -> dict:
    (n_extras,) = struct.unpack_from("<I", blob, off)
    off += 4
    extras = {}
    for _ in range(n_extras):
        klen, vlen = struct.unpack_from("<II", blob, off)
        off += 8
        k = bytes(blob[off : off + klen]).decode()
        off += klen
        extras[k] = bytes(blob[off : off + vlen])
        off += vlen
    return extras


class LaneStore:
    """Lazy per-lane byte access over one backing buffer (e.g. a memoryview
    over an mmap): ``store[i]`` copies out exactly lane ``i``."""

    __slots__ = ("_buf", "_offs", "_lens")

    def __init__(self, buf, offsets: np.ndarray, lengths: np.ndarray):
        self._buf = buf
        self._offs = np.asarray(offsets, np.int64)
        self._lens = np.asarray(lengths, np.int64)

    def __len__(self) -> int:
        return int(self._lens.size)

    def __getitem__(self, i: int) -> bytes:
        o, n = int(self._offs[i]), int(self._lens[i])
        return bytes(self._buf[o : o + n])

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    @property
    def nbytes(self) -> int:
        return int(self._lens.sum())

    def release(self) -> None:
        """Drop the reference to the backing buffer, so the mmap under it
        can close; the store is unusable afterwards."""
        self._buf = None


def lanes_nbytes(tile_blobs) -> int:
    if isinstance(tile_blobs, LaneStore):
        return tile_blobs.nbytes
    return sum(len(b) for b in tile_blobs)


def _index_nbytes(n_tiles: int) -> int:
    """Extent of the checksummed v3 index: u64 lens | u32 crcs | u32 meta."""
    return 8 * n_tiles + 4 * n_tiles + 4


def lane_offset(artifact: "TiledCompressed", i: int) -> int:
    """Container-relative byte offset of lane ``i`` (for error reports)."""
    tb = artifact.tile_blobs
    if isinstance(tb, LaneStore):
        return int(tb._offs[i])
    base = _HDR_V3.size + 16 * len(artifact.shape)
    return base + sum(len(tb[j]) for j in range(i))


# ---------------------------------------------------------------------------
# tile grid geometry
# ---------------------------------------------------------------------------


def normalize_tile(tile, ndim: int) -> tuple[int, ...]:
    if isinstance(tile, int):
        tile = (tile,) * ndim
    tile = tuple(int(t) for t in tile)
    if len(tile) != ndim or any(t < 1 for t in tile):
        raise ValueError(f"tile {tile} invalid for a {ndim}-d volume")
    return tile


def tile_grid(shape: tuple[int, ...], tile: tuple[int, ...]) -> tuple[int, ...]:
    return tuple(-(-d // t) for d, t in zip(shape, tile))


def pad_to_tiles(x: torch.Tensor, tile: tuple[int, ...]) -> torch.Tensor:
    """Edge-mode padding to whole tiles, as an index-clamp gather per axis
    (any rank)."""
    for ax, (d, g, t) in enumerate(zip(x.shape, tile_grid(x.shape, tile), tile)):
        if g * t != d:
            idx = torch.arange(g * t, device=x.device).clamp_(max=d - 1)
            x = x.index_select(ax, idx)
    return x


def split_tiles(xp: torch.Tensor, tile: tuple[int, ...]) -> torch.Tensor:
    """[g0*t0, g1*t1, ...] -> [prod(g), t0, t1, ...] in row-major grid order."""
    grid = tuple(d // t for d, t in zip(xp.shape, tile))
    nd = len(tile)
    interleaved = xp.reshape(sum(((g, t) for g, t in zip(grid, tile)), ()))
    perm = tuple(range(0, 2 * nd, 2)) + tuple(range(1, 2 * nd, 2))
    return interleaved.permute(perm).reshape((-1,) + tuple(tile))


def stitch_tiles(tiles: torch.Tensor, grid: tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`split_tiles`: [prod(g), *tile] -> padded volume."""
    tile = tuple(tiles.shape[1:])
    nd = len(tile)
    blocks = tiles.reshape(tuple(grid) + tile)
    perm = sum(((d, nd + d) for d in range(nd)), ())
    return blocks.permute(perm).reshape(tuple(g * t for g, t in zip(grid, tile)))


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------


@dataclass
class TiledCompressed:
    """Self-describing tiled artifact (``GWTC``, docs/TILED_FORMAT.md).

    ``tile_blobs[i]`` is the independent lane of tile ``i`` in row-major grid
    order (for ``lorenzo`` a bare ``RPRE`` entropy blob)."""

    shape: tuple[int, ...]
    tile: tuple[int, ...]
    eb_abs: float
    backend: str
    tile_blobs: list[bytes]
    predictor: str = "lorenzo"
    order: str = "cubic"
    levels: int = 0
    extras: dict = field(default_factory=dict)
    # per-lane CRC-32s from the footer index (None when the container has
    # none), and the opener's policy: verify in {"none", "lazy"}, on_corrupt
    # in {"raise", "quarantine"}.  None of these is part of the artifact.
    lane_crcs: np.ndarray | None = field(default=None, repr=False, compare=False)
    verify: str = field(default="lazy", repr=False, compare=False)
    on_corrupt: str = field(default="raise", repr=False, compare=False)
    fill_value: float = field(default=0.0, repr=False, compare=False)
    _verified: set = field(default_factory=set, init=False, repr=False, compare=False)
    quarantined: set = field(default_factory=set, init=False, repr=False, compare=False)

    @property
    def grid(self) -> tuple[int, ...]:
        return tile_grid(self.shape, self.tile)

    @property
    def n_tiles(self) -> int:
        return int(np.prod(self.grid))

    @property
    def nbytes(self) -> int:
        """Serialized (v3) size, from the lane index alone."""
        return (_HDR_V3.size + 16 * len(self.shape) + lanes_nbytes(self.tile_blobs)
                + len(_pack_extras(self.extras))
                + _index_nbytes(len(self.tile_blobs)) + _FOOTER_V3.size)

    def size_report(self) -> dict:
        lanes = lanes_nbytes(self.tile_blobs)
        extras = len(_pack_extras(self.extras))
        index = _index_nbytes(len(self.tile_blobs)) + _FOOTER_V3.size
        header = _HDR_V3.size + 16 * len(self.shape)
        return {"lanes": lanes, "index": index, "extras": extras,
                "header": header, "total": header + lanes + extras + index}

    def to_bytes(self) -> bytes:
        """GWTC v3 bytes, written through the same writer streaming uses."""
        from repro_torch.exec.writer import GWTCWriter

        buf = io.BytesIO()
        w = GWTCWriter(buf, shape=self.shape, tile=self.tile, eb_abs=self.eb_abs,
                       backend=self.backend, predictor=self.predictor,
                       order=self.order, levels=self.levels)
        for lane in self.tile_blobs:
            w.append_lane(lane)
        w.extras.update(self.extras)
        w.finalize()
        return buf.getvalue()

    @staticmethod
    def from_bytes(blob) -> "TiledCompressed":
        """Parse a GWTC v1/v2/v3 blob (``bytes``, or any buffer, whose lanes
        then stay behind a lazy :class:`LaneStore`).  Structural damage
        raises :class:`CorruptContainerError`; lane CRCs are checked at
        decode time."""
        try:
            magic, ver = struct.unpack_from("<4sB", blob, 0)
        except struct.error as e:
            raise CorruptContainerError(f"truncated GWTC blob: {e}", offset=0) from e
        if magic != _MAGIC:
            raise CorruptContainerError(
                "bad GWTC magic", offset=0, expected=_MAGIC, actual=bytes(magic))
        try:
            if ver == 1:  # predates the predictor layer: always Lorenzo
                _m, _v, nd, backend, _pad, ebbits, n_tiles = _HDR_V1.unpack_from(blob, 0)
                pred, order, levels = PRED_IDS["lorenzo"], ORDER_IDS["cubic"], 0
                off = _HDR_V1.size
            elif ver in (2, 3):
                (_m, _v, nd, backend, pred, order, levels, _pad, ebbits,
                 n_tiles) = _HDR_V2.unpack_from(blob, 0)
                off = _HDR_V2.size
            else:
                raise CorruptContainerError(
                    "unsupported GWTC version", offset=4, expected="1..3",
                    actual=int(ver))
            if not 1 <= nd <= 16:
                raise CorruptContainerError(
                    "implausible GWTC rank", offset=5, expected="1..16", actual=int(nd))
            if backend not in _BACKENDS_INV:
                raise CorruptContainerError(
                    "unknown GWTC entropy backend id", offset=6,
                    expected=sorted(_BACKENDS_INV), actual=int(backend))
            if pred not in PRED_NAMES or order not in ORDER_NAMES:
                raise CorruptContainerError(
                    "unknown GWTC predictor/order id", offset=7,
                    actual=(int(pred), int(order)))
            shape = struct.unpack_from(f"<{nd}q", blob, off)
            off += 8 * nd
            tile = struct.unpack_from(f"<{nd}q", blob, off)
            off += 8 * nd
        except struct.error as e:
            raise CorruptContainerError(f"truncated GWTC header: {e}", offset=0) from e
        if any(d < 1 for d in shape) or any(t < 1 for t in tile):
            raise CorruptContainerError(
                "non-positive GWTC shape/tile dims", offset=_HDR_V3.size,
                actual=(tuple(map(int, shape)), tuple(map(int, tile))))
        want_tiles = int(np.prod(tile_grid(tuple(shape), tuple(tile))))
        if n_tiles != want_tiles:
            raise CorruptContainerError(
                "GWTC tile count disagrees with the shape/tile grid",
                offset=off - 16 * nd, expected=want_tiles, actual=int(n_tiles))
        lane_crcs = None
        if ver in (1, 2):  # index-first layout: lane lengths precede the lanes
            if off + 8 * n_tiles > len(blob):
                raise CorruptContainerError(
                    "truncated GWTC index", offset=off,
                    expected=f">= {off + 8 * n_tiles} bytes", actual=len(blob))
            raw_lens = np.frombuffer(blob, np.uint64, n_tiles, offset=off)
            # exact-int sum: garbage u64 lens must not wrap past the check
            lens_sum = sum(map(int, raw_lens))
            lens = raw_lens.astype(np.int64)
            off += 8 * n_tiles
            lanes_start = off
            extras_off = lanes_start + lens_sum
            if (lens < 0).any() or extras_off + 4 > len(blob):
                raise CorruptContainerError(
                    "GWTC lane extent overruns the blob", offset=lanes_start,
                    expected=f"extras at byte {extras_off}", actual=len(blob))
        else:  # v3: the footer locates extras and the trailing index
            lanes_start = off
            if len(blob) < lanes_start + _FOOTER_V3.size:
                raise CorruptContainerError(
                    "truncated GWTC v3 blob (no footer)",
                    offset=max(0, len(blob) - _FOOTER_V3.size),
                    expected=f">= {lanes_start + _FOOTER_V3.size} bytes",
                    actual=len(blob))
            footer_off = len(blob) - _FOOTER_V3.size
            extras_off, index_off = _FOOTER_V3.unpack_from(blob, footer_off)
            if not lanes_start <= extras_off <= index_off <= footer_off:
                raise CorruptContainerError(
                    "corrupt GWTC v3 footer (offsets out of range)", offset=footer_off,
                    actual=(int(extras_off), int(index_off)))
            region = footer_off - index_off
            if region == _index_nbytes(n_tiles):
                has_crcs = True
            elif region == 8 * n_tiles:
                has_crcs = False  # pre-checksum v3 container
            else:
                raise CorruptContainerError(
                    "GWTC v3 index region has an impossible extent", offset=index_off,
                    expected=(_index_nbytes(n_tiles), 8 * n_tiles), actual=int(region))
            raw_lens = np.frombuffer(blob, np.uint64, n_tiles, offset=index_off)
            lens_sum = sum(map(int, raw_lens))
            lens = raw_lens.astype(np.int64)
            if (lens < 0).any() or lanes_start + lens_sum != extras_off:
                raise CorruptContainerError(
                    "corrupt GWTC v3 blob (index / lane extent mismatch)",
                    offset=index_off, expected=int(extras_off) - lanes_start,
                    actual=lens_sum)
            if has_crcs:
                lane_crcs = np.frombuffer(
                    blob, np.uint32, n_tiles, offset=index_off + 8 * n_tiles).copy()
                (meta_crc,) = struct.unpack_from("<I", blob, index_off + 12 * n_tiles)
                got = zlib.crc32(bytes(blob[extras_off:index_off]),
                                 zlib.crc32(bytes(blob[:lanes_start]))) & 0xFFFFFFFF
                if got != meta_crc:
                    raise CorruptContainerError(
                        "GWTC metadata checksum mismatch (header/shape/extras "
                        "bytes are damaged)", offset=index_off + 12 * n_tiles,
                        expected=f"0x{meta_crc:08x}", actual=f"0x{got:08x}")
        offs = lanes_start + np.concatenate([[0], np.cumsum(lens[:-1])])
        if isinstance(blob, (bytes, bytearray)):
            tile_blobs = [bytes(blob[o : o + ln]) for o, ln in zip(offs, lens)]
        else:
            tile_blobs = LaneStore(blob, offs, lens)
        try:
            extras = _unpack_extras(blob, extras_off)
        except struct.error as e:
            raise CorruptContainerError(
                f"truncated GWTC extras blob: {e}", offset=int(extras_off)) from e
        return TiledCompressed(
            shape=tuple(shape), tile=tuple(tile),
            eb_abs=float(np.uint64(ebbits).view(np.float64)),
            backend=_BACKENDS_INV[backend], tile_blobs=tile_blobs,
            predictor=PRED_NAMES[pred], order=ORDER_NAMES[order],
            levels=int(levels), extras=extras, lane_crcs=lane_crcs)


A.register_container(_MAGIC, TiledCompressed)


# ---------------------------------------------------------------------------
# engine API
# ---------------------------------------------------------------------------


def compress_tiled(x, tile=(64, 64, 64), *, rel_eb: float | None = None,
                   abs_eb: float | None = None, backend: str = "huffman+zlib",
                   predictor: str = "lorenzo", order: str = "cubic",
                   max_levels: int = 5, device=None):
    """Tile-grid compress; returns (artifact, reconstruction tensor).

    ``x`` is an array or tensor; it runs on ``device`` (None: the CUDA
    device, which must exist).  The reconstruction is the decode's own
    output cropped to ``x.shape``: exactly what :func:`decompress_tiled`
    returns."""
    if backend not in _BACKENDS:
        raise ValueError(f"unknown entropy backend {backend!r}")
    pred = get_predictor(predictor)
    device = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(device)
    tile = normalize_tile(tile, x.ndim)
    eb = resolve_eb(x, rel_eb, abs_eb)
    levels = pred.plan(tile, max_levels)
    tiles = split_tiles(pad_to_tiles(x, tile), tile)
    payload, recon_tiles = pred.encode_tiles(tiles, eb, order=order, levels=levels)
    recon = stitch_tiles(recon_tiles, tile_grid(tuple(x.shape), tile))
    blobs = [pred.lane_bytes(payload, i, backend) for i in range(tiles.shape[0])]
    artifact = TiledCompressed(
        shape=tuple(x.shape), tile=tile, eb_abs=eb, backend=backend,
        tile_blobs=blobs, predictor=predictor, order=order, levels=levels)
    return artifact, recon[tuple(slice(0, d) for d in x.shape)]


def _check_lane(artifact: TiledCompressed, i: int, blob) -> bool:
    """Verify lane ``i`` against its footer CRC (at most once per lane).

    True when the lane is usable.  On a mismatch: raises
    :class:`CorruptLaneError` under ``on_corrupt="raise"``, or records the
    lane in ``artifact.quarantined`` and returns False under
    ``"quarantine"``."""
    if i in artifact.quarantined:
        return False
    if artifact.lane_crcs is None or artifact.verify == "none" or i in artifact._verified:
        return True
    expected = int(artifact.lane_crcs[i])
    actual = lane_crc(blob)
    if actual == expected:
        artifact._verified.add(i)
        return True
    if artifact.on_corrupt == "quarantine":
        artifact.quarantined.add(i)
        return False
    raise CorruptLaneError(i, lane_offset=lane_offset(artifact, i),
                           expected_crc=expected, actual_crc=actual)


def verify_lanes(artifact: TiledCompressed, lane_ids=None) -> list[int]:
    """Checksum the given lanes (all, by default) without decoding them: the
    ``verify="full"`` open policy.  Returns the quarantined lane ids (always
    empty under ``on_corrupt="raise"``, which raises instead), and ``[]``
    at once when the container carries no checksums or ``verify="none"``."""
    if artifact.lane_crcs is None or artifact.verify == "none":
        return []
    ids = range(artifact.n_tiles) if lane_ids is None else lane_ids
    for i in ids:
        _check_lane(artifact, i, artifact.tile_blobs[i])
    return sorted(artifact.quarantined)


def decode_lanes(artifact: TiledCompressed, lane_ids, *, with_mask: bool = False,
                 device=None):
    """Decode the named lanes; returns ``(recon [len(ids), *tile], n_decoded)``,
    or with ``with_mask=True`` also the mask of quarantined positions (filled
    with ``artifact.fill_value``).  Lanes with a CRC are checked before their
    first decode."""
    device = resolve_device(device)
    pred = get_predictor(artifact.predictor)
    lane_ids = list(lane_ids)
    blobs = [artifact.tile_blobs[i] for i in lane_ids]
    good = [j for j, (i, b) in enumerate(zip(lane_ids, blobs))
            if _check_lane(artifact, i, b)]
    items = [pred.parse_lane(blobs[j], tile=artifact.tile, levels=artifact.levels,
                             device=device) for j in good]
    tile = tuple(artifact.tile)
    recon = None
    if good:
        payload = {k: torch.stack([it[k] for it in items]) for k in items[0]}
        recon = pred.decode_tiles(payload, artifact.eb_abs, tile=tile,
                                  order=artifact.order, levels=artifact.levels)
    bad_mask = np.ones(len(lane_ids), bool)
    bad_mask[good] = False
    if bad_mask.any():
        full = torch.full((len(lane_ids),) + tile, float(artifact.fill_value),
                          dtype=torch.float32, device=device)
        if good:
            full[torch.as_tensor(good, device=device)] = recon
        recon = full
    if with_mask:
        return recon, len(good), bad_mask
    return recon, len(good)


def apply_tile_transform(tile_transform, recon: torch.Tensor, bad_mask: np.ndarray,
                         fill_value: float) -> torch.Tensor:
    """Run a per-tile transform (``[K, *tile] -> [K, *tile]``, e.g. the GWLZ
    enhancer; None: identity) over decoded tiles in one call, then re-fill
    quarantined tiles.  Eager PyTorch compiles nothing per batch size, so
    nothing is bucketed; the transform must act on each tile alone, so
    region and full decode stay bit-identical."""
    if tile_transform is None:
        return recon
    return _refill_quarantined(tile_transform(recon), bad_mask, fill_value)


def _refill_quarantined(recon: torch.Tensor, bad_mask: np.ndarray,
                        fill_value: float) -> torch.Tensor:
    """Re-assert the fill value on quarantined tile positions after a tile
    transform ran: an enhancer must not fabricate data for a lane that
    failed its checksum."""
    if bad_mask.any():
        recon[torch.as_tensor(np.nonzero(bad_mask)[0], device=recon.device)] = float(fill_value)
    return recon


def decompress_tiled(artifact: TiledCompressed, *, device=None,
                     tile_transform=None) -> torch.Tensor:
    """Full decode: every lane, stitched and cropped to the original shape.

    ``tile_transform([K, *tile]) -> [K, *tile]`` post-processes the decoded
    tiles before stitching (the GWLZ pipeline enhances per tile through it;
    a ``gwlz`` extras blob is otherwise ignored here, as in the reference)."""
    recon, _, bad = decode_lanes(artifact, range(artifact.n_tiles), with_mask=True,
                                 device=device)
    recon = apply_tile_transform(tile_transform, recon, bad, artifact.fill_value)
    out = stitch_tiles(recon, artifact.grid)
    return out[tuple(slice(0, d) for d in artifact.shape)]


def normalize_roi(roi, shape: tuple[int, ...]) -> tuple[tuple[int, int], ...]:
    """ROI as slices or (start, stop) pairs -> clamped (start, stop) tuples."""
    if len(roi) != len(shape):
        raise ValueError(f"roi rank {len(roi)} != volume rank {len(shape)}")
    out = []
    for r, d in zip(roi, shape):
        if isinstance(r, slice):
            if r.step not in (None, 1):
                raise ValueError("roi slices must have step 1")
            start, stop, _ = r.indices(d)
        else:
            start, stop = r
            start = start + d if start < 0 else start
            stop = stop + d if stop < 0 else stop
            start, stop = max(0, min(start, d)), max(0, min(stop, d))
        if stop <= start:
            raise ValueError(f"empty roi extent {r} on a dim of size {d}")
        out.append((int(start), int(stop)))
    return tuple(out)


def region_tiles(artifact: TiledCompressed, roi) -> tuple[np.ndarray, tuple]:
    """(flat lane ids of tiles intersecting ``roi``, per-dim tile ranges)."""
    bounds = normalize_roi(roi, artifact.shape)
    ranges = tuple((lo // t, -(-hi // t)) for (lo, hi), t in zip(bounds, artifact.tile))
    axes = [np.arange(a, b) for a, b in ranges]
    coords = np.meshgrid(*axes, indexing="ij")
    ids = np.ravel_multi_index([c.ravel() for c in coords], artifact.grid)
    return ids, (bounds, ranges)


def assemble_region(recon: torch.Tensor, geom, tile: tuple[int, ...]) -> torch.Tensor:
    """Stitch + crop decoded region tiles (the geometry half of
    :func:`decompress_region`)."""
    bounds, ranges = geom
    block = stitch_tiles(recon, tuple(b - a for a, b in ranges))
    crop = tuple(slice(lo - a * t, hi - a * t)
                 for (lo, hi), (a, _b), t in zip(bounds, ranges, tile))
    return block[crop]


def decompress_region(artifact: TiledCompressed, roi, *, device=None,
                      tile_transform=None) -> torch.Tensor:
    """Decode only the tiles intersecting ``roi`` (and run ``tile_transform``
    on exactly those); bit-identical to ``decompress_tiled(artifact)[roi]``."""
    ids, geom = region_tiles(artifact, roi)
    recon, _, bad = decode_lanes(artifact, ids.tolist(), with_mask=True, device=device)
    recon = apply_tile_transform(tile_transform, recon, bad, artifact.fill_value)
    return assemble_region(recon, geom, artifact.tile)
