"""Tile sources: uniform, bounded-memory access to volume data (port of
``repro/exec/sources.py``).

The streaming executor never sees a whole volume: it asks a source for
one rectangular block at a time (a tile's extent, clamped to the volume).
Sources are host numpy readers; only the executor's tile batch goes to the
device.  They adapt the inputs :func:`repro_torch.api.compress_stream`
accepts:

* in-memory arrays and ``np.memmap`` views (:class:`ArraySource`: memmap
  block reads fault in only the touched pages),
* ``.npy`` paths (:class:`NpyFileSource`: opened with
  ``np.load(mmap_mode="r")``, so nothing is materialized),
* iterators of axis-0 slabs (:class:`IterSource`: a plane-window buffer
  holds only the slabs covering the current tile row).
"""
from __future__ import annotations

import os

import numpy as np


class TileSource:
    """Protocol: ``shape`` plus rectangular block reads.

    ``rescannable`` sources can be read more than once (needed to resolve a
    *relative* error bound, which takes a min/max prepass); one-shot
    iterator sources are not and require ``abs_eb``."""

    shape: tuple[int, ...]
    rescannable: bool = True

    def read_block(self, lo: tuple[int, ...], hi: tuple[int, ...]) -> np.ndarray:
        """float32 copy of ``x[lo:hi]`` (executor-owned; mutation is fine)."""
        raise NotImplementedError

    def read_tile(self, lo, hi, tile: tuple[int, ...]) -> np.ndarray:
        """One tile's block, edge-padded to the full tile shape: the same
        values ``tiled.pad_to_tiles`` + ``split_tiles`` would produce."""
        block = self.read_block(lo, hi)
        pads = [(0, t - (h - l)) for l, h, t in zip(lo, hi, tile)]
        if any(p for _z, p in pads):
            block = np.pad(block, pads, mode="edge")
        return block

    def close(self) -> None:  # pragma: no cover - trivial default
        pass


class ArraySource(TileSource):
    """Blocks out of an in-memory ndarray or an ``np.memmap`` view."""

    def __init__(self, a: np.ndarray):
        self._a = a
        self.shape = tuple(int(d) for d in a.shape)

    def read_block(self, lo, hi) -> np.ndarray:
        sl = tuple(slice(l, h) for l, h in zip(lo, hi))
        return np.asarray(self._a[sl], np.float32)


class NpyFileSource(ArraySource):
    """``.npy`` file opened as a read-only memmap: block reads touch only
    the pages under the requested extent."""

    def __init__(self, path):
        self.path = os.fspath(path)
        super().__init__(np.load(self.path, mmap_mode="r"))

    def close(self) -> None:
        mm = getattr(self._a, "_mmap", None)
        self._a = None
        if mm is not None:
            mm.close()


class IterSource(TileSource):
    """One-shot iterator of axis-0 slabs with a declared total ``shape``.

    Keeps a sliding window of planes: tile batches arrive in row-major grid
    order, so the first-axis extent of successive reads is nondecreasing:
    planes behind the window are dropped as soon as the next tile row
    starts.  Peak buffer: one tile row of planes plus the largest incoming
    slab."""

    rescannable = False

    def __init__(self, it, shape: tuple[int, ...]):
        self._it = iter(it)
        self.shape = tuple(int(d) for d in shape)
        self._win_start = 0  # first buffered plane
        self._buf = np.zeros((0,) + self.shape[1:], np.float32)

    def _advance(self, lo0: int, hi0: int) -> None:
        if lo0 < self._win_start:
            raise ValueError(
                f"iterator source cannot seek backwards (plane {lo0} < window "
                f"start {self._win_start}); tile reads must be row-major")

        def drop_front() -> None:
            # planes both buffered and behind the window start are consumed
            d = min(lo0 - self._win_start, self._buf.shape[0])
            if d:
                self._buf = self._buf[d:]
                self._win_start += d

        drop_front()
        while self._win_start + self._buf.shape[0] < hi0:
            try:
                slab = np.asarray(next(self._it), np.float32)
            except StopIteration:
                raise ValueError(
                    f"iterator source exhausted at plane "
                    f"{self._win_start + self._buf.shape[0]} of {self.shape[0]}"
                ) from None
            if slab.ndim == len(self.shape) - 1:
                slab = slab[None]
            if slab.shape[1:] != self.shape[1:]:
                raise ValueError(
                    f"slab shape {slab.shape} does not match volume planes "
                    f"{self.shape[1:]}")
            if not self._buf.shape[0] and self._win_start + slab.shape[0] <= lo0:
                self._win_start += slab.shape[0]  # skipped whole slab: no copy
            else:
                self._buf = slab if not self._buf.shape[0] else \
                    np.concatenate([self._buf, slab])
                drop_front()

    def read_block(self, lo, hi) -> np.ndarray:
        self._advance(lo[0], hi[0])
        a, b = lo[0] - self._win_start, hi[0] - self._win_start
        sl = (slice(a, b),) + tuple(slice(l, h) for l, h in zip(lo[1:], hi[1:]))
        return np.array(self._buf[sl], np.float32)


def as_source(src, *, shape=None) -> TileSource:
    """Adapt whatever the caller has into a :class:`TileSource`.

    Accepts a source instance, a ``.npy`` path, any array (ndarray, memmap,
    CPU tensor), or an iterable of axis-0 slabs (``shape`` required)."""
    if isinstance(src, TileSource):
        return src
    if isinstance(src, (str, os.PathLike)):
        path = os.fspath(src)
        if not path.endswith(".npy"):
            raise ValueError(
                f"streaming sources read .npy volumes, got {path!r} "
                "(decode other containers through api.open)")
        return NpyFileSource(path)
    if hasattr(src, "__array__") or isinstance(src, np.ndarray):
        a = src if isinstance(src, (np.ndarray, np.memmap)) else np.asarray(src)
        return ArraySource(a)
    if hasattr(src, "__iter__") or hasattr(src, "__next__"):
        if shape is None:
            raise ValueError("iterator sources need an explicit shape=")
        return IterSource(src, shape)
    raise TypeError(f"cannot stream from a {type(src).__name__}")


def value_range(source: TileSource, slab_planes: int = 8) -> tuple[float, float]:
    """Streaming (min, max) prepass over a rescannable source: what a
    *relative* error bound needs before any tile is encoded."""
    if not source.rescannable:
        raise ValueError(
            "relative error bounds need a min/max prepass, which a one-shot "
            "iterator source cannot replay; pass abs_eb instead")
    shape = source.shape
    lo_v, hi_v = np.inf, -np.inf
    for p in range(0, shape[0], slab_planes):
        block = source.read_block(
            (p,) + (0,) * (len(shape) - 1),
            (min(p + slab_planes, shape[0]),) + shape[1:])
        lo_v = min(lo_v, float(block.min()))
        hi_v = max(hi_v, float(block.max()))
    return lo_v, hi_v
