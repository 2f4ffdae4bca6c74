"""Size-capped, thread-safe LRU cache of decoded tiles and the cross-request
decode micro-batcher (port of ``repro/exec/cache.py``).

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

:class:`DecodeBatcher` layers above the claims: concurrent requests that own
claimed lanes of one volume submit them to a shared round, and one leader
decodes the union in one call (the serving daemon's batcher).
"""
from __future__ import annotations

import threading
import time
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


class _Round:
    """One micro-batch round for a group: the ids accumulated so far, the
    completion event, and the shared outcome (result dict or error)."""

    __slots__ = ("ids", "done", "result", "error")

    def __init__(self):
        self.ids: list = []
        self.done = threading.Event()
        self.result: dict | None = None
        self.error: BaseException | None = None


class DecodeBatcher:
    """Cross-request decode micro-batcher (continuous batching).

    Concurrent region requests that each own a few claimed tiles of the same
    volume would issue one device dispatch apiece; the batcher coalesces them:
    the FIRST submitter for a group becomes the round's *leader*, waits up to
    ``max_wait_ms`` for followers to append their tile ids, then decodes the
    union in one call (one ``decode_lanes`` batch: nothing is padded or
    bucketed, since eager PyTorch compiles nothing per batch size) and hands
    every submitter its slice.
    Followers that arrive after the leader drained the round start the next
    round — there is no global tick, so an idle volume pays zero latency and
    a busy one forms batches back-to-back.

    This layers ABOVE the single-flight claim/fulfill protocol: submitters
    only bring ids they already own claims for, so the batcher never sees a
    duplicate decode across requests (dedup within a round is still applied
    in case two submitters race the same abandoned claim).  The leader calls
    ``decode_fn`` OUTSIDE the lock; it holds no cache locks while waiting, so
    batching cannot deadlock against claim/fulfill.

    ``max_batch_tiles`` wakes the leader early once enough work is pending —
    the latency knob bounds the wait, the size knob bounds the batch."""

    def __init__(self, *, max_wait_ms: float = 2.0, max_batch_tiles: int = 256):
        self.max_wait_ms = float(max_wait_ms)
        self.max_batch_tiles = int(max_batch_tiles)
        self._cv = threading.Condition()
        self._rounds: dict = {}  # guarded-by: _cv
        self.submits = 0  # guarded-by: _cv
        self.dispatches = 0  # guarded-by: _cv
        self.coalesced_submits = 0  # guarded-by: _cv
        self.pending_tiles = 0  # guarded-by: _cv
        self.peak_pending_tiles = 0  # guarded-by: _cv
        self.batch_hist: dict = {}  # guarded-by: _cv

    def submit(self, group, lane_ids, decode_fn) -> dict:
        """Decode ``lane_ids`` (for ``group``) via a shared round; returns
        ``{lane_id: tile}`` for exactly the requested ids.

        ``decode_fn(ids)`` must return ``{id: np.ndarray}`` for the union of
        a round's ids; it runs once per round, on the leader's thread.  A
        leader-side decode error propagates to every submitter in the round
        (all their claims fail together — callers abandon and re-raise, the
        single-flight protocol's normal error path)."""
        lane_ids = list(lane_ids)
        if not lane_ids:
            return {}
        deadline = None
        with self._cv:
            self.submits += 1
            rnd = self._rounds.get(group)
            leader = rnd is None
            if leader:
                rnd = self._rounds[group] = _Round()
            else:
                self.coalesced_submits += 1
            rnd.ids.extend(lane_ids)
            self.pending_tiles += len(lane_ids)
            self.peak_pending_tiles = max(self.peak_pending_tiles,
                                          self.pending_tiles)
            self._cv.notify_all()
            if leader:
                deadline = time.monotonic() + self.max_wait_ms / 1e3
                while (len(rnd.ids) < self.max_batch_tiles
                       and (remaining := deadline - time.monotonic()) > 0):
                    self._cv.wait(remaining)
                # drain: later submits for this group start a fresh round
                del self._rounds[group]
                ids = list(dict.fromkeys(rnd.ids))
                self.pending_tiles -= len(rnd.ids)
                self.dispatches += 1
                self.batch_hist[len(ids)] = self.batch_hist.get(len(ids), 0) + 1
        if leader:
            try:
                rnd.result = decode_fn(ids)
            except BaseException as e:
                rnd.error = e
                raise
            finally:
                rnd.done.set()
        else:
            rnd.done.wait()
            if rnd.error is not None:
                raise rnd.error
        return {i: rnd.result[i] for i in lane_ids}

    def info(self) -> dict:
        """Snapshot for ``/metrics`` (histogram keys stringified for JSON)."""
        with self._cv:
            return {"submits": self.submits, "dispatches": self.dispatches,
                    "coalesced_submits": self.coalesced_submits,
                    "pending_tiles": self.pending_tiles,
                    "peak_pending_tiles": self.peak_pending_tiles,
                    "max_wait_ms": self.max_wait_ms,
                    "max_batch_tiles": self.max_batch_tiles,
                    "batch_hist": {str(k): v
                                   for k, v in sorted(self.batch_hist.items())}}
