"""One front door for the compression stack, port of ``repro/api.py``.

Callers get one surface for both containers (monolithic ``SZJX``, tiled
``GWTC``), enhancer attachment and random-access decode, behind a
numpy-like handle:

    from repro_torch import api

    vol = api.compress(x, eb=1e-3, predictor="lorenzo", tiled=True)
    api.save("field.gwlz", vol)

    vol = api.open("field.gwlz")          # sniffs the magic, picks the decoder
    full = np.asarray(vol)                # full decode (cached once)
    roi  = vol[8:40, :, 16:32]            # tiled: decodes only the lanes it meets

Opening is mmap-backed and lazy (a region read pages in just the lanes it
decodes), and handles are context managers over the mapping.

Every entry point takes ``device=None``, meaning the CUDA device (which
must exist); pass ``device="cpu"`` to run the plain PyTorch versions.  The
handle decodes on its device and returns numpy arrays.

Not ported yet: ``compress_stream`` (ROADMAP.md Queue 1 item 7) and the
multi-field ``Dataset`` / ``GWDS`` envelope (item 9); they raise
:class:`NotImplementedError`.
"""
from __future__ import annotations

import itertools
import mmap as _mmap
import os
import threading
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.pipeline import GWLZ, GWLZStats
from repro_torch.core.trainer import GWLZTrainConfig
from repro_torch.errors import CorruptContainerError, CorruptLaneError, IntegrityError
from repro_torch.exec.cache import TileCache
from repro_torch.kernels.ops import resolve_device
from repro_torch.sz import artifact as A
from repro_torch.sz import tiled as _tiled
from repro_torch.sz.szjax import SZCompressed, SZCompressor
from repro_torch.sz.tiled import LaneStore, TiledCompressed, region_tiles

__all__ = [
    "CompressedVolume",
    "CorruptContainerError",
    "CorruptLaneError",
    "DecodeStats",
    "IntegrityError",
    "compress",
    "compress_stream",
    "open",
    "save",
    "from_bytes",
    "region_lane_count",
    "GWDS_MAGIC",
]

_VERIFY_POLICIES = ("none", "lazy", "full")
_CORRUPT_POLICIES = ("raise", "quarantine")

GWDS_MAGIC = A.GWDS_MAGIC
_GWDS_TODO = ("multi-field GWDS datasets are not ported yet "
              "(ROADMAP.md Queue 1 item 9)")

# Default byte cap for the per-handle decoded-tile LRU cache.
DEFAULT_TILE_CACHE_BYTES = int(os.environ.get("REPRO_TILE_CACHE_BYTES", 256 << 20))

_builtin_open = open  # shadowed below by the façade's open()


def _apply_verify(artifact, verify: str, on_corrupt: str, fill_value: float):
    """Install a verification policy on a parsed artifact and, under
    ``verify="full"``, checksum every lane up front.  Monolithic ``SZJX``
    artifacts carry no per-lane CRCs: the policy is a no-op there, as it is
    for pre-checksum ``GWTC`` containers."""
    if verify not in _VERIFY_POLICIES:
        raise ValueError(f"verify must be one of {_VERIFY_POLICIES}, got {verify!r}")
    if on_corrupt not in _CORRUPT_POLICIES:
        raise ValueError(f"on_corrupt must be one of {_CORRUPT_POLICIES}, got {on_corrupt!r}")
    if isinstance(artifact, TiledCompressed):
        artifact.verify = verify
        artifact.on_corrupt = on_corrupt
        artifact.fill_value = float(fill_value)
        if verify == "full":
            _tiled.verify_lanes(artifact)
    return artifact


def _release_resources(resources: tuple) -> None:
    """Best-effort release of handle-owned mmap/file resources, in order
    (views before their mmap, the mmap before its file)."""
    for r in resources:
        try:
            if isinstance(r, memoryview):
                r.release()
            else:
                r.close()
        except (BufferError, OSError):  # pragma: no cover - best effort
            pass


class DecodeStats:
    """Per-handle decode counts: ``tiles_decoded`` (lanes this handle
    decoded), ``tiles_total`` (lanes in the artifact), ``cache_hits``
    (reads served from the tile cache, another thread's in-flight decode or
    the full-decode cache) and ``quarantined`` (lanes that failed their CRC
    under ``on_corrupt="quarantine"``).  Exact under concurrent reads (one
    lock per handle).  When the volume carries train-time
    :class:`~repro_torch.core.pipeline.GWLZStats`, their attributes forward
    through this object (``vol.stats.psnr_gwlz``)."""

    def __init__(self, tiles_total: int, train: GWLZStats | None = None):
        self._lock = threading.Lock()
        self.tiles_decoded = 0  # guarded-by: _lock
        self.tiles_total = tiles_total
        self.cache_hits = 0  # guarded-by: _lock
        self.quarantined = 0  # guarded-by: _lock
        self._train = train

    def record(self, *, decoded: int = 0, hits: int = 0) -> None:
        """Atomically account one read's lane touches."""
        with self._lock:
            self.tiles_decoded += decoded
            self.cache_hits += hits

    def record_quarantined(self, n: int) -> None:
        """Absolute update from the artifact's (grow-only) quarantine set."""
        with self._lock:
            if n > self.quarantined:
                self.quarantined = n

    def __getattr__(self, name):
        train = self.__dict__.get("_train")
        if train is not None and not name.startswith("_"):
            return getattr(train, name)
        raise AttributeError(
            f"DecodeStats has no attribute {name!r} (train-time GWLZStats "
            "are only attached by enhanced compression)")

    def __repr__(self) -> str:
        s = (f"DecodeStats(tiles_decoded={self.tiles_decoded}, "
             f"tiles_total={self.tiles_total}, cache_hits={self.cache_hits}")
        if self.quarantined:
            s += f", quarantined={self.quarantined}"
        return s + (", +train)" if self._train is not None else ")")


# ---------------------------------------------------------------------------
# the handle
# ---------------------------------------------------------------------------

# Process-wide namespace allocator for tile-cache keys: every handle keys its
# entries as ``(ns, tile_id)``, so many handles can share one TileCache.
_VOL_NS = itertools.count(1)


class CompressedVolume:
    """Lazy numpy-like handle over a compressed artifact.

    ``shape``/``dtype``/``nbytes``/``stats``/``size_report()``,
    ``np.asarray(vol)`` for the full decode, and numpy-style slicing.
    Slicing routes to the region decoder on tiled artifacts (only the
    lanes it meets decode; an attached enhancer runs per decoded tile) and
    crops the full decode, computed once and cached, on monolithic ones.
    Region and full decode are bit-identical either way.

    ``tile_cache`` injects a SHARED :class:`TileCache`: the handle keys its
    entries under ``cache_ns`` (default: a fresh process-unique id), never
    clears entries it does not own, and on :meth:`close` drops only its own
    namespace.  Decoding runs on ``device`` (None: the CUDA device)."""

    def __init__(self, artifact, *, stats: GWLZStats | None = None,
                 pipeline: GWLZ | None = None, cache_bytes: int | None = None,
                 tile_cache: TileCache | None = None, cache_ns=None, device=None):
        self.device = resolve_device(device)
        self.artifact = artifact
        self.train_stats = stats  # GWLZStats from enhanced compression, or None
        self.pipeline = pipeline or GWLZ()
        self._cache: np.ndarray | None = None  # one-shot full-decode cache
        tiles_total = artifact.n_tiles if isinstance(artifact, TiledCompressed) else 1
        self.stats = DecodeStats(tiles_total, train=stats)
        self._owns_cache = tile_cache is None
        self.tile_cache = tile_cache if tile_cache is not None else TileCache(
            DEFAULT_TILE_CACHE_BYTES if cache_bytes is None else cache_bytes)
        self.cache_ns = cache_ns if cache_ns is not None else next(_VOL_NS)
        self._resources: tuple = ()  # mmap/file handles owned by this handle
        self._closed = False

    # -- lifecycle ---------------------------------------------------------

    def _adopt_resources(self, resources: tuple) -> None:
        """Take ownership of open/mmap resources (released by close())."""
        self._resources = tuple(resources)

    def _ensure_open(self) -> None:
        if self._closed:
            raise ValueError("operation on a closed CompressedVolume")

    def close(self) -> None:
        """Drop the decode caches and release the backing mmap (if any).
        Idempotent; after close, decoding raises."""
        if self._closed:
            return
        self._closed = True
        self._cache = None
        if self._owns_cache:
            self.tile_cache.clear()
        else:  # shared cache: evict only this handle's namespace
            self.tile_cache.drop_namespace(self.cache_ns)
        lanes = getattr(self.artifact, "tile_blobs", None)
        if isinstance(lanes, LaneStore):
            lanes.release()
        _release_resources(self._resources)
        self._resources = ()

    def __enter__(self) -> "CompressedVolume":
        self._ensure_open()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- metadata ----------------------------------------------------------

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.artifact.shape)

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(np.float32)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def nbytes(self) -> int:
        """Compressed size: what :func:`save` writes to disk."""
        return self.artifact.nbytes

    @property
    def eb_abs(self) -> float:
        return float(self.artifact.eb_abs)

    @property
    def tiled(self) -> bool:
        return isinstance(self.artifact, TiledCompressed)

    @property
    def enhanced(self) -> bool:
        """True when a trained GWLZ enhancer model rides in the artifact."""
        return "gwlz" in self.artifact.extras

    def size_report(self) -> dict:
        return self.artifact.size_report()

    def to_bytes(self) -> bytes:
        return self.artifact.to_bytes()

    def __repr__(self) -> str:
        kind = "GWTC tiled" if self.tiled else "SZJX"
        enh = "+gwlz" if self.enhanced else ""
        return (f"CompressedVolume({kind}{enh}, shape={self.shape}, "
                f"eb_abs={self.eb_abs:.4g}, nbytes={self.nbytes})")

    # -- decode ------------------------------------------------------------

    def decode(self) -> np.ndarray:
        """Full decode (enhancer applied when attached), cached once.  The
        returned array is read-only: it IS the cache (monolithic slices are
        cut from it).  Copy to mutate."""
        self._ensure_open()
        if self._cache is None:
            self._cache = self.pipeline.decode(self.artifact, device=self.device).cpu().numpy()
            self._cache.setflags(write=False)
            self.stats.record(decoded=self.stats.tiles_total)
            self._sync_quarantine()
        else:
            self.stats.record(hits=self.stats.tiles_total)
        return self._cache

    def _sync_quarantine(self) -> None:
        q = getattr(self.artifact, "quarantined", None)
        if q:
            self.stats.record_quarantined(len(q))

    def _tiles_for(self, ids: list[int]) -> np.ndarray:
        """Final (enhanced) tile values for the given lane ids, through the
        size-capped (possibly shared) LRU with single-flight coalescing:
        cached tiles return as they are, lanes nobody is decoding are claimed
        and decode in ONE batched pipeline call, and lanes another thread
        already claimed are awaited.  An abandoned claim (the owner's decode
        raised) wakes the waiters, one of which re-claims and retries."""
        cache, ns = self.tile_cache, self.cache_ns
        found: dict[int, np.ndarray] = {}
        decoded = 0
        pending = list(dict.fromkeys(ids))
        while pending:
            got, mine, theirs = cache.claim([(ns, i) for i in pending])
            for (_n, i), v in got.items():
                found[i] = v
            if mine:
                mine_ids = [k[1] for k in mine]
                try:
                    dec = self.pipeline.decode_tiles(self.artifact, mine_ids,
                                                     device=self.device).cpu().numpy()
                except BaseException:
                    cache.abandon(mine)
                    raise
                for j, k in enumerate(mine):
                    tile = np.ascontiguousarray(dec[j])
                    cache.fulfill(k, tile)
                    found[k[1]] = tile
                decoded += len(mine)
            pending = []
            for k, flight in theirs.items():
                v = cache.wait(flight)
                if v is None:  # owner abandoned: re-claim this lane
                    pending.append(k[1])
                else:
                    found[k[1]] = v
        self.stats.record(decoded=decoded, hits=len(ids) - decoded)
        self._sync_quarantine()
        return np.stack([found[i] for i in ids])

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        arr = self.decode()
        if dtype is not None and np.dtype(dtype) != arr.dtype:
            return arr.astype(dtype)
        if copy:
            return arr.copy()
        return arr

    def __getitem__(self, key) -> np.ndarray:
        """Numpy-style slicing (ints, slices with any positive step,
        Ellipsis; missing trailing axes are full slices).  Tiled artifacts
        always route through the region decoder (and never fill the
        full-decode cache); monolithic ones crop the cached full decode."""
        self._ensure_open()
        specs = self._normalize_key(key)
        if any(hi <= lo for lo, hi, _step, _sq in specs):
            shape = tuple(_strided_len(lo, hi, step) for lo, hi, step, sq in specs if not sq)
            return np.empty(shape, np.float32)
        if self.tiled:
            roi = tuple(slice(lo, hi) for lo, hi, _s, _q in specs)
            ids, geom = region_tiles(self.artifact, roi)
            tiles = torch.from_numpy(self._tiles_for(ids.tolist()))
            block = _tiled.assemble_region(tiles, geom, self.artifact.tile).numpy()
            origin = [lo for lo, _h, _s, _q in specs]
        else:
            block = self.decode()
            origin = [0] * self.ndim
        crop = tuple(lo - o if sq else slice(lo - o, hi - o, step)
                     for (lo, hi, step, sq), o in zip(specs, origin))
        out = block[crop]
        # container-independent contract: slices are fresh writable arrays,
        # so monolithic crops (views of the read-only cache) copy
        return out if out.flags.writeable else out.copy()

    def _normalize_key(self, key) -> list[tuple[int, int, int, bool]]:
        """key -> per-dim (lo, hi, step, squeeze) with 0 <= lo, hi <= dim."""
        if not isinstance(key, tuple):
            key = (key,)
        if any(k is Ellipsis for k in key):
            i = key.index(Ellipsis)
            if any(k is Ellipsis for k in key[i + 1:]):
                raise IndexError("an index can only have a single ellipsis")
            fill = self.ndim - (len(key) - 1)
            key = key[:i] + (slice(None),) * fill + key[i + 1:]
        if len(key) > self.ndim:
            raise IndexError(f"too many indices for a {self.ndim}-d compressed volume")
        key = key + (slice(None),) * (self.ndim - len(key))
        specs = []
        for k, d in zip(key, self.shape):
            if isinstance(k, (int, np.integer)):
                i = int(k) + d if k < 0 else int(k)
                if not 0 <= i < d:
                    raise IndexError(f"index {int(k)} out of bounds for dim of size {d}")
                specs.append((i, i + 1, 1, True))
            elif isinstance(k, slice):
                start, stop, step = k.indices(d)
                if step < 1:
                    raise IndexError(
                        "negative-step slicing is not supported on a "
                        "CompressedVolume; decode with np.asarray() first")
                specs.append((start, max(start, stop), step, False))
            else:
                raise IndexError(f"unsupported index {k!r}; use ints, slices, or Ellipsis")
        return specs


def _strided_len(lo: int, hi: int, step: int) -> int:
    return max(0, -(-(hi - lo) // step))


# ---------------------------------------------------------------------------
# compress
# ---------------------------------------------------------------------------


def compress(x, *, eb: float | None = None, abs_eb: float | None = None,
             tiled: bool = False, tile=(64, 64, 64),
             enhance: bool | GWLZTrainConfig = False, predictor: str = "interp",
             order: str = "cubic", backend: str = "huffman+zlib", max_levels: int = 5,
             clamp_to_bound: bool = False, callback=None, device=None) -> CompressedVolume:
    """Compress ``x`` into a :class:`CompressedVolume` handle.

    ``eb`` is the *relative* error bound (scaled by the value range);
    ``abs_eb`` is absolute: pass exactly one.  ``tiled=True`` selects the
    random-access ``GWTC`` container over the tile grid ``tile``;
    ``predictor``/``order``/``backend`` configure the transform and entropy
    stages on either path (the default predictor, interp, is not ported
    yet: pass ``predictor="lorenzo"``).  ``enhance`` trains group-wise GWLZ
    enhancers and attaches them: ``True`` uses the default
    :class:`GWLZTrainConfig`, or pass a config; the handle's ``stats`` then
    carries the paper's metrics."""
    device = resolve_device(device)
    sz = SZCompressor(predictor, order, backend, max_levels)
    if not enhance:
        if tiled:
            artifact, _recon = sz.compress_tiled(x, tile, rel_eb=eb, abs_eb=abs_eb,
                                                 device=device)
        else:
            artifact, _recon = sz.compress(x, rel_eb=eb, abs_eb=abs_eb, device=device)
        return CompressedVolume(artifact, pipeline=GWLZ(sz=sz, clamp_to_bound=clamp_to_bound),
                                device=device)
    cfg = enhance if isinstance(enhance, GWLZTrainConfig) else GWLZTrainConfig()
    gw = GWLZ(sz=sz, train_cfg=cfg, clamp_to_bound=clamp_to_bound)
    return gw.compress_volume(x, tiled=tiled, tile=tile, rel_eb=eb, abs_eb=abs_eb,
                              callback=callback, device=device)


def compress_stream(source, out, **kwargs):
    """Out-of-core compress through the streaming executor: not ported yet
    (ROADMAP.md Queue 1 item 7)."""
    raise NotImplementedError("compress_stream is not ported yet "
                              "(ROADMAP.md Queue 1 item 7)")


# ---------------------------------------------------------------------------
# persistence: save / open (self-sniffing)
# ---------------------------------------------------------------------------


def from_bytes(blob, *, pipeline: GWLZ | None = None, cache_bytes: int | None = None,
               tile_cache: TileCache | None = None, cache_ns=None, verify: str = "lazy",
               on_corrupt: str = "raise", fill_value: float = 0.0,
               device=None) -> CompressedVolume:
    """Sniff the envelope magic and build the handle (``SZJX``/``GWTC``).
    ``blob`` may be bytes or any buffer (a memoryview over an mmap parses
    lazily: tiled lanes stay on disk until a decode touches them).
    ``verify`` / ``on_corrupt`` / ``fill_value`` install the integrity
    policy described under :func:`open`."""
    device = resolve_device(device)
    if A.sniff_magic(blob) == GWDS_MAGIC:
        raise NotImplementedError(_GWDS_TODO)
    art = _apply_verify(A.from_bytes(blob), verify, on_corrupt, fill_value)
    return CompressedVolume(art, pipeline=pipeline, cache_bytes=cache_bytes,
                            tile_cache=tile_cache, cache_ns=cache_ns, device=device)


def save(path: str | os.PathLike, obj) -> int:
    """Write a volume handle (or bare artifact) to ``path`` as its container
    bytes, verbatim (bytes on disk == ``vol.nbytes``); returns the byte
    count."""
    if isinstance(obj, CompressedVolume):
        blob = obj.to_bytes()
    elif isinstance(obj, Mapping):
        raise NotImplementedError(_GWDS_TODO)
    elif isinstance(obj, (SZCompressed, TiledCompressed)):
        blob = obj.to_bytes()
    else:
        raise TypeError(f"cannot save {type(obj).__name__}; expected CompressedVolume "
                        "or artifact")
    with _builtin_open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def open(path: str | os.PathLike, *, pipeline: GWLZ | None = None, mmap: bool = True,
         cache_bytes: int | None = None, tile_cache: TileCache | None = None,
         cache_ns=None, verify: str = "lazy", on_corrupt: str = "raise",
         fill_value: float = 0.0, device=None) -> CompressedVolume:
    """Open a compressed file (``SZJX`` or ``GWTC``; an attached GWLZ model
    is applied on decode), sniffing the envelope to pick the decoder.

    By default the file is memory-mapped and parsed lazily; the handle owns
    the mapping (use it as a context manager, or ``close()``);
    ``mmap=False`` reads it whole.  ``cache_bytes`` caps the handle's
    decoded-tile cache (default ``REPRO_TILE_CACHE_BYTES`` or 256 MiB; 0
    disables it), or ``tile_cache`` injects a shared one keyed under
    ``cache_ns``.

    Integrity: structural damage raises
    :class:`~repro_torch.errors.CorruptContainerError` here.  ``verify`` sets
    the per-lane CRC policy: ``"lazy"`` (default) checks a lane on its first
    decode, ``"full"`` every lane at open, ``"none"`` none.  A failed lane
    raises :class:`~repro_torch.errors.CorruptLaneError` or, with
    ``on_corrupt="quarantine"``, decodes as ``fill_value`` while
    ``vol.stats.quarantined`` counts the damaged tiles."""
    device = resolve_device(device)
    f = _builtin_open(path, "rb")
    mm = None
    if mmap:
        try:
            mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        except (ValueError, OSError):
            mm = None  # empty or unmappable file: read it whole
    kw = dict(pipeline=pipeline, cache_bytes=cache_bytes, tile_cache=tile_cache,
              cache_ns=cache_ns, verify=verify, on_corrupt=on_corrupt,
              fill_value=fill_value, device=device)
    if mm is None:
        with f:
            blob = f.read()
        return from_bytes(blob, **kw)
    mv = memoryview(mm)
    try:
        obj = from_bytes(mv, **kw)
    except BaseException:
        mv.release()
        mm.close()
        f.close()
        raise
    obj._adopt_resources((mv, mm, f))
    return obj


def region_lane_count(vol: CompressedVolume, roi) -> tuple[int, int]:
    """(lanes a region decode of ``roi`` touches, total lanes) for a tiled
    volume; monolithic volumes report (1, 1), and an empty ROI touches 0
    lanes on either container."""
    specs = vol._normalize_key(roi)
    total = vol.artifact.n_tiles if vol.tiled else 1
    if any(hi <= lo for lo, hi, _step, _sq in specs):
        return (0, total)
    if not vol.tiled:
        return (1, 1)
    ids, _ = region_tiles(vol.artifact, tuple((lo, hi) for lo, hi, _s, _q in specs))
    return (int(ids.size), total)
