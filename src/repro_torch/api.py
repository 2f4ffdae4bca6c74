"""One front door for the compression stack, port of ``repro/api.py``.

Callers get one surface for both containers (monolithic ``SZJX``, tiled
``GWTC``), enhancer attachment and random-access decode, behind a
numpy-like handle:

    from repro_torch import api

    vol = api.compress(x, eb=1e-3, tiled=True)
    api.save("field.gwlz", vol)

    vol = api.open("field.gwlz")          # sniffs the magic, picks the decoder
    full = np.asarray(vol)                # full decode (cached once)
    roi  = vol[8:40, :, 16:32]            # tiled: decodes only the lanes it meets

Multi-field snapshots persist as one ``GWDS`` envelope (named fields behind
one offset index, docs/DATASET_FORMAT.md):

    api.save("snapshot.gwds", {"temperature": vol_t, "baryon_density": vol_b})
    ds = api.open("snapshot.gwds")        # a Dataset; fields parse on first access
    ds["temperature"][0:16, :, :]

Opening is mmap-backed and lazy (a region read pages in just the lanes it
decodes), and handles are context managers over the mapping.

Every entry point takes ``device=None``, meaning the CUDA device (which
must exist); pass ``device="cpu"`` to run the plain PyTorch versions.  The
handle decodes on its device and returns numpy arrays.

The default predictor is interp (SZ3-style interpolation), as in the
reference; ``predictor="lorenzo"`` selects the Lorenzo predictor.
:func:`compress_stream` is the out-of-core path: it streams a ``.npy``
memmap, an array or a slab iterator into a ``GWTC`` container under a byte
budget (Lorenzo by default, as in the reference).
"""
from __future__ import annotations

import io
import itertools
import mmap as _mmap
import os
import threading
from collections.abc import Iterator, Mapping

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.pipeline import GWLZ, GWLZStats
from repro_torch.core.trainer import GWLZTrainConfig
from repro_torch.errors import CorruptContainerError, CorruptLaneError, IntegrityError
from repro_torch.exec.cache import TileCache
from repro_torch.exec.writer import GWDSWriter, parse_gwds
from repro_torch.kernels.ops import resolve_device
from repro_torch.sz import artifact as A
from repro_torch.sz import tiled as _tiled
from repro_torch.sz.szjax import SZCompressed, SZCompressor
from repro_torch.sz.tiled import LaneStore, TiledCompressed, region_tiles

__all__ = [
    "CompressedVolume",
    "CorruptContainerError",
    "CorruptLaneError",
    "Dataset",
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
    namespace.  ``decode_batcher`` (a :class:`DecodeBatcher`, which the
    serving pool injects) decodes the lanes a read claims in rounds shared
    with concurrent reads of this volume.  Decoding runs on ``device``
    (None: the CUDA device)."""

    def __init__(self, artifact, *, stats: GWLZStats | None = None,
                 pipeline: GWLZ | None = None, cache_bytes: int | None = None,
                 tile_cache: TileCache | None = None, cache_ns=None, decode_batcher=None,
                 device=None):
        self.device = resolve_device(device)
        self.artifact = artifact
        self.train_stats = stats  # GWLZStats from enhanced compression, or None
        self.pipeline = pipeline or GWLZ()
        self.decode_batcher = decode_batcher
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
        with obs.op("to_bytes"):
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
        with obs.op("decode"):
            if self._cache is None:
                with torch.no_grad():  # grad mode is per thread; a decode needs no graph
                    dec = self.pipeline.decode(self.artifact, device=self.device)
                with obs.op("to_host"):
                    self._cache = dec.cpu().numpy()
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

    def _tiles_for(self, ids: list[int], span=None) -> np.ndarray:
        """Final (enhanced) tile values for the given lane ids, through the
        size-capped (possibly shared) LRU with single-flight coalescing:
        cached tiles return as they are, lanes nobody is decoding are claimed
        and decode in ONE batched pipeline call (:meth:`_decode_claimed`),
        and lanes another thread already claimed are awaited.  An abandoned
        claim (the owner's decode raised) wakes the waiters, one of which
        re-claims and retries.  ``span`` (an ``obs`` span) gets the read's
        ``tiles`` and ``hits``."""
        cache, ns = self.tile_cache, self.cache_ns
        found: dict[int, np.ndarray] = {}
        decoded = 0
        pending = list(dict.fromkeys(ids))
        while pending:
            got, mine, theirs = cache.claim([(ns, i) for i in pending])
            for (_n, i), v in got.items():
                found[i] = v
            if mine:
                try:
                    got = self._decode_claimed([k[1] for k in mine])
                except BaseException:
                    cache.abandon(mine)
                    raise
                for k in mine:
                    tile = got[k[1]]
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
        if span is not None:
            span.set(tiles=len(ids), hits=len(ids) - decoded)
        self._sync_quarantine()
        return np.stack([found[i] for i in ids])

    def _decode_claimed(self, mine_ids: list[int]) -> dict[int, np.ndarray]:
        """Decode lanes this read owns claims for: one pipeline call, or with
        a ``decode_batcher`` a round shared with concurrent reads of this
        volume (group key: the cache namespace).  The round's leader decodes
        on this handle's device, on its own thread, and hands out host
        tiles; its error reaches every submitter of the round."""

        def decode(ids: list[int]) -> dict[int, np.ndarray]:
            with torch.no_grad():  # grad mode is per thread; a decode needs no graph
                dec = self.pipeline.decode_tiles(self.artifact, ids, device=self.device)
            dec = dec.cpu().numpy()
            return {i: np.ascontiguousarray(dec[j]) for j, i in enumerate(ids)}

        if self.decode_batcher is None:
            return decode(mine_ids)
        return self.decode_batcher.submit(self.cache_ns, mine_ids, decode)

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
            with obs.op("region") as s:
                ids, geom = region_tiles(self.artifact, roi)
                tiles = torch.from_numpy(self._tiles_for(ids.tolist(), span=s))
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
    stages on either path (interp, cubic by default; or ``"lorenzo"``).
    ``enhance`` trains group-wise GWLZ
    enhancers and attaches them: ``True`` uses the default
    :class:`GWLZTrainConfig`, or pass a config; the handle's ``stats`` then
    carries the paper's metrics."""
    device = resolve_device(device)
    sz = SZCompressor(predictor, order, backend, max_levels)
    with obs.op("compress"):
        if not enhance:
            if tiled:
                artifact, _recon = sz.compress_tiled(x, tile, rel_eb=eb, abs_eb=abs_eb,
                                                     device=device)
            else:
                artifact, _recon = sz.compress(x, rel_eb=eb, abs_eb=abs_eb, device=device)
            return CompressedVolume(
                artifact, pipeline=GWLZ(sz=sz, clamp_to_bound=clamp_to_bound), device=device)
        cfg = enhance if isinstance(enhance, GWLZTrainConfig) else GWLZTrainConfig()
        gw = GWLZ(sz=sz, train_cfg=cfg, clamp_to_bound=clamp_to_bound)
        return gw.compress_volume(x, tiled=tiled, tile=tile, rel_eb=eb, abs_eb=abs_eb,
                                  callback=callback, device=device)


def compress_stream(source, out, *, eb: float | None = None, abs_eb: float | None = None,
                    tile=(64, 64, 64), mem_budget: int = 256 << 20, predictor: str = "lorenzo",
                    order: str = "cubic", backend: str = "huffman+zlib", max_levels: int = 5,
                    enhance: bool | GWLZTrainConfig = False, shape=None, resume: bool = False,
                    retry=None, device=None):
    """Out-of-core compress: stream ``source`` into a ``GWTC`` container at
    ``out`` without ever materializing the volume (docs/STREAMING.md).

    ``source`` is a ``.npy`` path, an array/``np.memmap``, a
    :class:`repro_torch.exec.TileSource`, or an iterator of axis-0 slabs
    (pass ``shape=``); ``out`` a path, file object, or an open
    :class:`repro_torch.exec.GWTCWriter`.  The executor reads tile batches
    sized against ``mem_budget`` on the host, encodes each on ``device``
    (None: the CUDA device, which must exist), overlaps that with the host
    append of the previous batch, and writes lanes through the incremental
    writer; the tile index lands in the container footer on finalize.
    ``enhance`` trains group-wise GWLZ enhancers on a reservoir sample of
    tile batches.  A relative ``eb`` takes a min/max prepass over the
    source, so one-shot iterator sources need ``abs_eb``.

    Returns a :class:`repro_torch.exec.StreamReport` (peak tracked bytes,
    batch geometry, container size).  Open the result with :func:`open`.

    Fault tolerance (docs/ROBUSTNESS.md): transient encode/append failures
    retry under ``retry`` (a :class:`repro_torch.runtime.fault.RetryPolicy`;
    default 3 attempts with backoff), each batch is journaled as it lands,
    and ``resume=True`` re-opens an interrupted path destination at its
    last committed batch; the resumed container is byte-identical to an
    uninterrupted run."""
    from repro_torch.exec import stream_compress

    with obs.op("stream"):
        return stream_compress(
            source, out, tile=tile, rel_eb=eb, abs_eb=abs_eb, backend=backend,
            predictor=predictor, order=order, max_levels=max_levels, mem_budget=mem_budget,
            enhance=(enhance if enhance else None), shape=shape, resume=resume, retry=retry,
            device=device)


# ---------------------------------------------------------------------------
# multi-field dataset (GWDS)
# ---------------------------------------------------------------------------


class Dataset(Mapping):
    """Lazy mapping of field name -> :class:`CompressedVolume` backed by one
    ``GWDS`` envelope (docs/DATASET_FORMAT.md).

    Field blobs parse on first access, into handles that decode on
    ``device`` (None: the CUDA device): opening a dataset reads the shared
    offset index only, so touching one field of a many-field snapshot never
    pays for the others.  When opened through :func:`open` the backing is
    an mmap, field parse is lazy down to the lane level, and :meth:`close`
    (or the context manager) closes every field handle and releases the
    mapping."""

    def __init__(self, blob, index: dict[str, tuple[int, int]], *,
                 pipeline: GWLZ | None = None, cache_bytes: int | None = None,
                 tile_cache: TileCache | None = None, verify: str = "lazy",
                 on_corrupt: str = "raise", fill_value: float = 0.0, device=None):
        self.device = resolve_device(device)
        self._blob = blob
        self._index = index
        self._pipeline = pipeline
        self._cache_bytes = cache_bytes
        self._tile_cache = tile_cache
        self._verify = verify
        self._on_corrupt = on_corrupt
        self._fill_value = fill_value
        self._cache: dict[str, CompressedVolume] = {}
        self._resources: tuple = ()
        self._closed = False

    @staticmethod
    def from_bytes(blob, *, pipeline: GWLZ | None = None, cache_bytes: int | None = None,
                   tile_cache: TileCache | None = None, verify: str = "lazy",
                   on_corrupt: str = "raise", fill_value: float = 0.0,
                   device=None) -> "Dataset":
        """Parse a v1 (index first, count in the header) or v2 (index in
        the footer) envelope's index; fields stay unparsed."""
        index = parse_gwds(blob)
        return Dataset(blob, index, pipeline=pipeline, cache_bytes=cache_bytes,
                       tile_cache=tile_cache, verify=verify, on_corrupt=on_corrupt,
                       fill_value=fill_value, device=device)

    @staticmethod
    def build(fields: Mapping) -> bytes:
        """Serialize named volumes or artifacts into one GWDS (v2) envelope,
        through :class:`~repro_torch.exec.writer.GWDSWriter`, so an eagerly
        built envelope is byte-identical to a streamed one."""
        if not fields:
            raise ValueError("a GWDS dataset needs at least one field")
        buf = io.BytesIO()
        w = GWDSWriter(buf)
        for name, vol in fields.items():
            art = vol.artifact if isinstance(vol, CompressedVolume) else vol
            if not isinstance(art, (SZCompressed, TiledCompressed)):
                raise TypeError(
                    f"GWDS field {name!r} is a {type(vol).__name__}; expected "
                    "CompressedVolume or artifact (compress it first)")
            w.add_field(name, art.to_bytes())
        w.finalize()
        return buf.getvalue()

    def __getitem__(self, name: str) -> CompressedVolume:
        if self._closed:
            raise ValueError("operation on a closed Dataset")
        if name not in self._cache:
            fo, fl = self._index[name]  # raises KeyError for unknown fields
            art = A.from_bytes(self._blob[fo : fo + fl])
            _apply_verify(art, self._verify, self._on_corrupt, self._fill_value)
            self._cache[name] = CompressedVolume(
                art, pipeline=self._pipeline, cache_bytes=self._cache_bytes,
                tile_cache=self._tile_cache, device=self.device)
        return self._cache[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._index)

    def __len__(self) -> int:
        return len(self._index)

    # -- lifecycle ---------------------------------------------------------

    def _adopt_resources(self, resources: tuple) -> None:
        self._resources = tuple(resources)

    def close(self) -> None:
        """Close every opened field handle, then release the backing mmap.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        for vol in self._cache.values():
            vol.close()
        self._cache = {}
        self._blob = b""
        _release_resources(self._resources)
        self._resources = ()

    def __enter__(self) -> "Dataset":
        if self._closed:
            raise ValueError("operation on a closed Dataset")
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    @property
    def fields(self) -> tuple[str, ...]:
        return tuple(self._index)

    @property
    def nbytes(self) -> int:
        return len(self._blob)

    def to_bytes(self) -> bytes:
        return self._blob if isinstance(self._blob, bytes) else bytes(self._blob)

    def size_report(self) -> dict:
        per_field = {n: fl for n, (_fo, fl) in self._index.items()}
        return {"fields": per_field, "index": self.nbytes - sum(per_field.values()),
                "total": self.nbytes}

    def __repr__(self) -> str:
        return f"Dataset(GWDS, fields={list(self._index)}, nbytes={self.nbytes})"


# ---------------------------------------------------------------------------
# persistence: save / open (self-sniffing)
# ---------------------------------------------------------------------------


def from_bytes(blob, *, pipeline: GWLZ | None = None, cache_bytes: int | None = None,
               tile_cache: TileCache | None = None, cache_ns=None, verify: str = "lazy",
               on_corrupt: str = "raise", fill_value: float = 0.0, decode_batcher=None,
               device=None):
    """Sniff the envelope magic and build the reader: ``SZJX``/``GWTC`` ->
    :class:`CompressedVolume`; ``GWDS`` -> :class:`Dataset`.  ``blob`` may
    be bytes or any buffer (a memoryview over an mmap parses lazily: tiled
    lanes stay on disk until a decode touches them).  ``verify`` /
    ``on_corrupt`` / ``fill_value`` install the integrity policy,
    ``tile_cache`` / ``cache_ns`` / ``decode_batcher`` the shared decode
    state, described under :func:`open`."""
    device = resolve_device(device)
    with obs.op("open"):
        if A.sniff_magic(blob) == GWDS_MAGIC:
            return Dataset.from_bytes(blob, pipeline=pipeline, cache_bytes=cache_bytes,
                                      tile_cache=tile_cache, verify=verify,
                                      on_corrupt=on_corrupt, fill_value=fill_value,
                                      device=device)
        art = _apply_verify(A.from_bytes(blob), verify, on_corrupt, fill_value)
        return CompressedVolume(art, pipeline=pipeline, cache_bytes=cache_bytes,
                                tile_cache=tile_cache, cache_ns=cache_ns,
                                decode_batcher=decode_batcher, device=device)


def save(path: str | os.PathLike, obj) -> int:
    """Write ``obj`` to ``path``; returns the byte count on disk.  A volume
    handle (or bare artifact) writes its container bytes verbatim (bytes on
    disk == ``vol.nbytes``); a ``{name: volume}`` mapping (or a
    :class:`Dataset`) writes one multi-field ``GWDS`` envelope."""
    if isinstance(obj, Dataset):
        blob = obj.to_bytes()
    elif isinstance(obj, Mapping):
        blob = Dataset.build(obj)
    elif isinstance(obj, (CompressedVolume, SZCompressed, TiledCompressed)):
        blob = obj.to_bytes()
    else:
        raise TypeError(f"cannot save {type(obj).__name__}; expected CompressedVolume, "
                        "artifact, Dataset, or a {name: volume} mapping")
    with _builtin_open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def open(path: str | os.PathLike, *, pipeline: GWLZ | None = None, mmap: bool = True,
         cache_bytes: int | None = None, tile_cache: TileCache | None = None,
         cache_ns=None, verify: str = "lazy", on_corrupt: str = "raise",
         fill_value: float = 0.0, decode_batcher=None, device=None):
    """Open a compressed file, sniffing the envelope to pick the decoder: a
    :class:`CompressedVolume` for ``SZJX`` and ``GWTC`` (an attached GWLZ
    model is applied on decode), a :class:`Dataset` for multi-field
    ``GWDS``.

    By default the file is memory-mapped and parsed lazily; the handle owns
    the mapping (use it as a context manager, or ``close()``);
    ``mmap=False`` reads it whole.  ``cache_bytes`` caps the handle's
    decoded-tile cache (default ``REPRO_TILE_CACHE_BYTES`` or 256 MiB; 0
    disables it), or ``tile_cache`` injects a shared one keyed under
    ``cache_ns`` (the serving pool's mode: closing such a handle evicts only
    its namespace).  ``decode_batcher`` (an
    :class:`~repro_torch.exec.cache.DecodeBatcher`) coalesces the lane
    decodes of concurrent region reads into shared rounds.

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
              fill_value=fill_value, decode_batcher=decode_batcher, device=device)
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
