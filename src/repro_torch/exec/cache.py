"""Size-capped, thread-safe LRU cache of decoded tiles (port of the
``TileCache`` of ``repro/exec/cache.py``; the ``DecodeBatcher`` there comes
with the serving daemon, ROADMAP.md Queue 1 item 8).

Backs ``repro_torch.api.CompressedVolume`` region reads: repeated or
overlapping ROI decodes hit finished tiles instead of re-running entropy
decode, prediction and enhancement.  Values are read-only numpy tiles
(post-enhancement, so a hit is the final answer); the cap is in BYTES, not
entries.

One instance may be SHARED by many volume handles: callers namespace their
keys, e.g. ``(volume_ns, tile_id)``, and :meth:`drop_namespace` evicts one
volume's tiles without disturbing its neighbours.

Besides plain ``get_many``/``put``, the cache implements **single-flight**
decode coalescing (:meth:`claim` / :meth:`fulfill` / :meth:`abandon`):
concurrent readers that miss on the same key agree on ONE owner to decode
it; everyone else blocks on the in-flight entry and receives the decoded
tile directly -- even when the cache itself is too small to retain it -- so
overlapping ROIs arriving together cost each lane exactly one decode.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np


class _Flight:
    """An in-flight decode: the owner decodes, waiters block on ``event``.

    ``value`` doubles as the hand-off channel so waiters get the tile even
    when a zero/over-capacity cache refuses to retain it; ``value is None``
    after the event fires means the owner failed — waiters re-claim."""

    __slots__ = ("event", "value")

    def __init__(self):
        self.event = threading.Event()
        self.value: np.ndarray | None = None


class TileCache:
    """LRU over ``key -> read-only np.ndarray`` with a byte capacity.

    All operations take the internal lock and are O(1) amortized; decoding
    itself happens OUTSIDE the cache (callers insert results), so the lock
    is never held across slow work.  ``capacity_bytes=0`` disables caching
    (every ``get`` misses, ``put`` drops) but single-flight coalescing
    still works — the in-flight hand-off does not go through the LRU.

    Observability: ``hits`` (``get_many``/``claim`` found the key),
    ``misses`` (a caller was told to decode it), and ``coalesced``
    (a caller waited on another thread's in-flight decode instead of
    duplicating it) are monotone counters reported by :meth:`info` with
    the derived ``hit_rate`` — hits over touched keys — which the serving
    daemon exposes as the truth on ``/metrics``."""

    def __init__(self, capacity_bytes: int):
        self.capacity = int(capacity_bytes)
        self._lock = threading.Lock()
        self._d: OrderedDict[object, np.ndarray] = OrderedDict()  # guarded-by: _lock
        self._nbytes = 0  # guarded-by: _lock
        self._inflight: dict[object, _Flight] = {}  # guarded-by: _lock
        self._hits = 0  # guarded-by: _lock
        self._misses = 0  # guarded-by: _lock
        self._coalesced = 0  # guarded-by: _lock

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._nbytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    @property
    def hits(self) -> int:
        with self._lock:
            return self._hits

    @property
    def misses(self) -> int:
        with self._lock:
            return self._misses

    def get_many(self, keys) -> dict:
        """Present entries among ``keys`` (each hit refreshed to MRU)."""
        out = {}
        with self._lock:
            for k in keys:
                v = self._d.get(k)
                if v is not None:
                    self._d.move_to_end(k)
                    out[k] = v
                    self._hits += 1
                else:
                    self._misses += 1
        return out

    # -- single-flight -----------------------------------------------------

    def claim(self, keys) -> tuple[dict, list, dict]:
        """Partition ``keys`` into ``(found, mine, theirs)`` atomically.

        ``found`` maps cached keys to their tiles (refreshed to MRU);
        ``mine`` lists the keys THIS caller now owns — it must decode them
        and :meth:`fulfill` (or :meth:`abandon`) every one; ``theirs`` maps
        keys another thread is already decoding to the :class:`_Flight` to
        wait on via :meth:`wait`."""
        found: dict = {}
        mine: list = []
        theirs: dict = {}
        with self._lock:
            for k in keys:
                v = self._d.get(k)
                if v is not None:
                    self._d.move_to_end(k)
                    found[k] = v
                    self._hits += 1
                elif k in self._inflight:
                    theirs[k] = self._inflight[k]
                    self._coalesced += 1
                else:
                    self._inflight[k] = _Flight()
                    mine.append(k)
                    self._misses += 1
        return found, mine, theirs

    def fulfill(self, key, arr: np.ndarray) -> None:
        """Complete an owned in-flight decode: insert into the LRU, hand
        the tile to every waiter, and release the flight."""
        self.put(key, arr)
        with self._lock:
            flight = self._inflight.pop(key, None)
        if flight is not None:
            flight.value = arr
            flight.event.set()

    def abandon(self, keys) -> None:
        """Release owned in-flight entries WITHOUT a value (decode failed).

        Waiters wake with ``value is None`` and re-claim — one of them
        becomes the new owner and retries (or re-raises the same error)."""
        with self._lock:
            flights = [self._inflight.pop(k, None) for k in keys]
        for flight in flights:
            if flight is not None:
                flight.event.set()

    @staticmethod
    def wait(flight: _Flight, timeout: float | None = None) -> np.ndarray | None:
        """Block until another thread's in-flight decode resolves; ``None``
        means the owner abandoned it and the caller should re-claim."""
        flight.event.wait(timeout)
        return flight.value

    # -- insert / evict ----------------------------------------------------

    def put(self, key, arr: np.ndarray) -> None:
        nb = int(arr.nbytes)
        if nb > self.capacity:
            return  # larger than the whole cache: never admit
        arr = np.ascontiguousarray(arr)
        arr.setflags(write=False)
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._nbytes -= old.nbytes
            self._d[key] = arr
            self._nbytes += nb
            while self._nbytes > self.capacity:
                _k, v = self._d.popitem(last=False)
                self._nbytes -= v.nbytes

    def drop_namespace(self, ns) -> int:
        """Evict every entry whose key is ``(ns, ...)`` — one closing volume
        leaving a shared cache.  Returns the number of tiles dropped."""
        with self._lock:
            doomed = [k for k in self._d
                      if isinstance(k, tuple) and k and k[0] == ns]
            for k in doomed:
                self._nbytes -= self._d.pop(k).nbytes
        return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._nbytes = 0

    def info(self) -> dict:
        """Snapshot: occupancy plus the true hit/miss/coalesced counts (a
        coalesced wait is neither — the decode happened, once, elsewhere)."""
        with self._lock:
            touched = self._hits + self._misses
            return {"tiles": len(self._d), "nbytes": self._nbytes,
                    "capacity": self.capacity, "hits": self._hits,
                    "misses": self._misses, "coalesced": self._coalesced,
                    "inflight": len(self._inflight),
                    "hit_rate": (self._hits / touched) if touched else 0.0}
