"""Multi-tenant region-decode daemon over the read path (port of
``repro/serve.py``; docs/SERVING.md).

Holds many open :class:`repro_torch.api.CompressedVolume` handles behind ONE
shared, budgeted :class:`repro_torch.exec.cache.TileCache` and serves
decoded regions to concurrent readers:

    GET /v/<name>/region?roi=8:40,:,16:32   -> .npy bytes of full[roi]
    GET /v/<name>/info                      -> volume metadata JSON
    GET /healthz                            -> liveness
    GET /metrics                            -> latency / cache / admission JSON

* **shared cache, namespaced keys** -- every handle is opened with
  ``api.open(path, tile_cache=pool.cache, cache_ns=name)``, so all volumes
  compete for one byte budget;
* **single-flight decode** -- overlapping ROIs claim tiles through
  ``TileCache.claim``, so each lane decodes once however many clients ask;
* **cross-request batching** -- a :class:`DecodeBatcher` gathers the lanes
  that concurrent requests to one volume claimed into one decode call;
* **admission control** -- request working sets are admitted against a
  byte budget; excess requests queue (bounded, then 503).

Decoding runs on the pool's device (``device=None``: the CUDA device, which
must exist; ``device="cpu"`` runs the kernels' plain versions), from the
handler threads: every decode path sets its own device, stream and grad
mode, so no thread relies on another's PyTorch state.  A kernel error on a
batch leader's thread reaches every request of its round (a 500), through
the claims' abandon-and-retry path; nothing is retried on the CPU.

Two deliberate differences from the reference:

* **admission price** -- a tiled request costs what the port's decode
  allocates: lanes x ``tile_working_bytes(..., device_entropy=True on the
  card)``, with no rounding to bucket widths (the port pads no batch);
  monolithic requests cost ``3 x prod(shape) x 4`` as in the reference;
* **ETag codec token** -- the volume's device type (``"cuda"``/``"cpu"``)
  where the reference hashes ``"pallas"``/``"host"``.

Shell entry: ``python -m repro_torch.cli serve``.
"""
from __future__ import annotations

import hashlib
import io
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from repro_torch import api
from repro_torch.cli import parse_roi
from repro_torch.errors import IntegrityError
from repro_torch.exec.cache import DecodeBatcher, TileCache
from repro_torch.exec.plan import tile_working_bytes
from repro_torch.kernels.ops import resolve_device
from repro_torch.sz import tiled as _tiled
from repro_torch.sz.tiled import TiledCompressed, normalize_roi

__all__ = [
    "AdmissionController",
    "RegionServer",
    "RequestRejected",
    "VolumePool",
    "fetch_json",
    "fetch_region",
]

DEFAULT_MEM_BUDGET = 256 << 20
# bounded latency history: enough for a stable p99 without unbounded growth
_LATENCY_WINDOW = 10_000


class RequestRejected(RuntimeError):
    """Admission control refused the request (queue full / admit timeout);
    the HTTP layer maps this to 503 Service Unavailable."""


class AdmissionController:
    """Byte-budgeted admission for concurrent decodes.

    Each request declares the working-set bytes its decode may allocate;
    ``admit`` blocks until the in-flight total fits the budget.  A request
    larger than the whole budget is admitted ALONE (when nothing else is in
    flight), so oversized ROIs serialize instead of deadlocking.
    ``max_queue`` bounds how many requests may wait; beyond it (or past
    ``timeout`` seconds) admission raises :class:`RequestRejected`."""

    def __init__(self, budget_bytes: int, *, max_queue: int = 1024, timeout: float = 60.0):
        self.budget = int(budget_bytes)
        self.max_queue = int(max_queue)
        self.timeout = float(timeout)
        self._cv = threading.Condition()
        self.inflight_bytes = 0  # guarded-by: _cv
        self.queue_depth = 0  # guarded-by: _cv
        self.peak_queue_depth = 0  # guarded-by: _cv
        self.rejected = 0  # guarded-by: _cv

    def admit(self, cost: int) -> None:
        cost = max(0, int(cost))
        deadline = time.monotonic() + self.timeout
        with self._cv:
            if self.queue_depth >= self.max_queue:
                self.rejected += 1
                raise RequestRejected(f"admission queue full ({self.max_queue} waiting)")
            self.queue_depth += 1
            self.peak_queue_depth = max(self.peak_queue_depth, self.queue_depth)
            try:
                while self.inflight_bytes and self.inflight_bytes + cost > self.budget:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cv.wait(remaining):
                        self.rejected += 1
                        raise RequestRejected(
                            f"admission timed out after {self.timeout:.0f}s "
                            f"({self.inflight_bytes} bytes in flight)")
                self.inflight_bytes += cost
            finally:
                self.queue_depth -= 1

    def release(self, cost: int) -> None:
        with self._cv:
            self.inflight_bytes -= max(0, int(cost))
            self._cv.notify_all()

    def info(self) -> dict:
        with self._cv:
            return {"budget_bytes": self.budget, "inflight_bytes": self.inflight_bytes,
                    "queue_depth": self.queue_depth,
                    "peak_queue_depth": self.peak_queue_depth, "rejected": self.rejected}


class _Metrics:
    """Lock-guarded request aggregates behind ``/metrics``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.started = time.monotonic()
        self.requests = 0  # guarded-by: _lock
        self.errors = 0  # guarded-by: _lock
        self.not_modified = 0  # guarded-by: _lock
        self.lanes_served = 0  # guarded-by: _lock
        self.per_volume: dict[str, int] = {}  # guarded-by: _lock
        self._latency_ms: deque[float] = deque(maxlen=_LATENCY_WINDOW)  # guarded-by: _lock

    def record(self, name: str, latency_ms: float, lanes: int) -> None:
        with self._lock:
            self.requests += 1
            self.lanes_served += lanes
            self.per_volume[name] = self.per_volume.get(name, 0) + 1
            self._latency_ms.append(latency_ms)

    def record_not_modified(self, name: str) -> None:
        """An ETag revalidation hit: answered 304 with no decode and no
        latency sample."""
        with self._lock:
            self.requests += 1
            self.not_modified += 1
            self.per_volume[name] = self.per_volume.get(name, 0) + 1

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = np.asarray(self._latency_ms, np.float64)
            out = {"uptime_s": time.monotonic() - self.started, "requests": self.requests,
                   "errors": self.errors, "not_modified": self.not_modified,
                   "lanes_served": self.lanes_served,
                   "per_volume_requests": dict(self.per_volume)}
        if lat.size:
            p50, p90, p99 = np.percentile(lat, [50, 90, 99])
            out["latency_ms"] = {"count": int(lat.size), "mean": float(lat.mean()),
                                 "p50": float(p50), "p90": float(p90), "p99": float(p99),
                                 "max": float(lat.max())}
        else:
            out["latency_ms"] = {"count": 0}
        return out


class VolumePool:
    """The daemon's pure-logic core: named volumes over one shared cache.

    HTTP-free, so tests drive it in process.  Volumes given as paths open on
    the pool's ``device`` with its shared cache and batcher, and are closed
    by :meth:`close`; pre-opened handles are registered as they are (open
    them with ``tile_cache=pool.cache`` to share the budget).
    ``batch_wait_ms=None`` disables the batcher."""

    def __init__(self, volumes=None, *, cache_bytes: int | None = None,
                 mem_budget: int = DEFAULT_MEM_BUDGET, max_queue: int = 1024,
                 admit_timeout: float = 60.0, verify: str = "lazy", on_corrupt: str = "raise",
                 fill_value: float = 0.0, batch_wait_ms: float | None = 2.0,
                 batch_max_tiles: int = 256, device=None):
        self.device = resolve_device(device)
        self.cache = TileCache(
            api.DEFAULT_TILE_CACHE_BYTES if cache_bytes is None else cache_bytes)
        self.admission = AdmissionController(mem_budget, max_queue=max_queue,
                                             timeout=admit_timeout)
        self.metrics = _Metrics()
        self.batcher = None if batch_wait_ms is None else DecodeBatcher(
            max_wait_ms=batch_wait_ms, max_batch_tiles=batch_max_tiles)
        self._open_kw = dict(verify=verify, on_corrupt=on_corrupt, fill_value=fill_value,
                             decode_batcher=self.batcher, device=self.device)
        self._volumes: dict[str, api.CompressedVolume] = {}  # guarded-by: _lock
        self._owned: set[str] = set()  # guarded-by: _lock
        self._etag_seeds: dict[str, str] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        for name, spec in dict(volumes or {}).items():
            self.add_volume(name, spec)

    def add_volume(self, name: str, spec) -> api.CompressedVolume:
        """Register ``spec`` (a path, or an open handle) under ``name``."""
        if isinstance(spec, api.CompressedVolume):
            vol, owned = spec, False
            if vol.decode_batcher is None:
                vol.decode_batcher = self.batcher
        else:
            obj = api.open(spec, tile_cache=self.cache, cache_ns=name, **self._open_kw)
            if isinstance(obj, api.Dataset):
                obj.close()
                raise ValueError(
                    f"{spec!r} is a GWDS dataset; register each field as its own volume "
                    "(open the field and pass the handle)")
            vol, owned = obj, True
        with self._lock:
            if name in self._volumes:
                if owned:
                    vol.close()
                raise ValueError(f"volume {name!r} already registered")
            self._volumes[name] = vol
            if owned:
                self._owned.add(name)
        return vol

    @property
    def names(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(self._volumes)

    def volume(self, name: str) -> api.CompressedVolume:
        with self._lock:
            try:
                return self._volumes[name]
            except KeyError:
                raise KeyError(f"no volume {name!r} "
                               f"(serving: {sorted(self._volumes)})") from None

    def _request_cost(self, vol: api.CompressedVolume, n_lanes: int) -> int:
        """Working-set bytes a region decode may allocate: the lanes times
        the streaming planner's per-tile estimate, with the device encode's
        words where the volume decodes on the card, and no rounding (the
        port's decode pads no batch).  Monolithic: a full decode."""
        art = vol.artifact
        if isinstance(art, TiledCompressed):
            return n_lanes * tile_working_bytes(art.tile, art.predictor, art.levels,
                                                device_entropy=vol.device.type == "cuda")
        return 3 * int(np.prod(art.shape)) * 4

    def _etag_seed(self, name: str, vol: api.CompressedVolume) -> str:
        """Per-volume ETag seed: container identity (shape, byte size, eb,
        codec settings, and the footer lane CRCs when present).  Computed
        once per registered volume."""
        with self._lock:
            cached = self._etag_seeds.get(name)
        if cached is not None:
            return cached
        art = vol.artifact
        h = hashlib.sha1()
        h.update(repr((name, tuple(vol.shape), int(vol.nbytes), float(vol.eb_abs))).encode())
        if isinstance(art, TiledCompressed):
            h.update(repr((art.predictor, art.backend, art.order, art.levels,
                           tuple(art.tile))).encode())
            if art.lane_crcs is not None:
                h.update(np.asarray(art.lane_crcs, np.uint32).tobytes())
        seed = h.hexdigest()
        with self._lock:
            self._etag_seeds[name] = seed
        return seed

    def region_etag(self, name: str, roi) -> tuple[str, tuple]:
        """Strong ETag for ``GET /v/<name>/region``: hash of the volume's
        identity, the *canonical* ROI (``"0:8"`` and ``":8"`` revalidate each
        other) and the volume's device type.  Returns ``(etag, parsed_roi)``;
        raises like :meth:`region` on bad input."""
        vol = self.volume(name)
        if isinstance(roi, str):
            roi = parse_roi(roi)
        try:
            canon = normalize_roi(roi, tuple(vol.shape))
        except TypeError as e:  # an integer axis: no (start, stop) pair
            raise ValueError(f"roi {roi!r} needs a start:stop range on every axis") from e
        digest = hashlib.sha1(
            f"{self._etag_seed(name, vol)}|{canon}|{vol.device.type}".encode()).hexdigest()
        return f'"{digest[:32]}"', roi

    def region(self, name: str, roi) -> tuple[np.ndarray, dict]:
        """Decode ``vol[roi]`` under admission control.

        ``roi`` is a roi-spec string (``"8:40,:,16:32"``) or a tuple of
        ints/slices.  Returns ``(block, meta)``; ``meta`` carries the
        request's latency, lanes touched / total, shape and cost.  Raises
        ``KeyError`` (unknown volume), ``IndexError``/``ValueError`` (bad
        ROI), :class:`RequestRejected` (admission) and
        :class:`~repro_torch.errors.IntegrityError` (a corrupt lane under
        ``on_corrupt="raise"``)."""
        vol = self.volume(name)
        if isinstance(roi, str):
            roi = parse_roi(roi)
        lanes, total = api.region_lane_count(vol, roi)
        cost = self._request_cost(vol, lanes)
        self.admission.admit(cost)
        t0 = time.perf_counter()
        try:
            block = vol[roi]
        finally:
            self.admission.release(cost)
        latency_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.record(name, latency_ms, lanes)
        meta = {"volume": name, "shape": list(block.shape), "dtype": str(block.dtype),
                "lanes": lanes, "lanes_total": total, "latency_ms": latency_ms,
                "cost_bytes": cost}
        return block, meta

    def info(self, name: str) -> dict:
        vol = self.volume(name)
        art = vol.artifact
        out = {"volume": name, "shape": list(vol.shape), "dtype": str(vol.dtype),
               "nbytes": vol.nbytes, "eb_abs": vol.eb_abs, "tiled": vol.tiled,
               "enhanced": vol.enhanced,
               "stats": {"tiles_decoded": vol.stats.tiles_decoded,
                         "tiles_total": vol.stats.tiles_total,
                         "cache_hits": vol.stats.cache_hits,
                         "quarantined": vol.stats.quarantined}}
        if vol.tiled:
            out.update(tile=list(art.tile), grid=list(art.grid), n_lanes=art.n_tiles,
                       predictor=art.predictor, backend=art.backend)
        return out

    def metrics_snapshot(self) -> dict:
        out = self.metrics.snapshot()
        out["cache"] = self.cache.info()
        out["admission"] = self.admission.info()
        if self.batcher is not None:
            out["batcher"] = self.batcher.info()
        decode = _tiled.dispatch_stats()  # process-wide: one dispatch per decode batch
        decode["batch_hist"] = {str(k): v for k, v in sorted(decode["batch_hist"].items())}
        out["decode"] = decode
        out["volumes"] = {n: self.info(n)["stats"] for n in self.names}
        return out

    def close(self) -> None:
        with self._lock:
            volumes, owned = self._volumes, self._owned
            self._volumes, self._owned = {}, set()
        for name, vol in volumes.items():
            if name in owned:
                vol.close()
        self.cache.clear()

    def __enter__(self) -> "VolumePool":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "repro-torch-serve/1"
    timeout = 30  # seconds a connection may sit idle between requests

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:  # pragma: no cover - debug aid
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, content_type: str,
              headers: dict | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj: dict, headers: dict | None = None) -> None:
        self._send(code, json.dumps(obj).encode() + b"\n", "application/json", headers)

    def _error(self, code: int, message: str) -> None:
        self.server.pool.metrics.record_error()
        self._json(code, {"error": message})

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        pool: VolumePool = self.server.pool
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            if parts == ["healthz"]:
                return self._json(200, {"status": "ok", "volumes": sorted(pool.names)})
            if parts == ["metrics"]:
                return self._json(200, pool.metrics_snapshot())
            if len(parts) == 3 and parts[0] == "v":
                _, name, verb = parts
                if verb == "info":
                    return self._json(200, pool.info(name))
                if verb == "region":
                    return self._region(pool, name, url.query)
            return self._error(404, f"no route {url.path!r} (routes: /healthz /metrics "
                                    "/v/<name>/info /v/<name>/region?roi=...)")
        except KeyError as e:
            return self._error(404, str(e))
        except RequestRejected as e:
            return self._error(503, str(e))
        except IntegrityError as e:
            return self._error(500, f"integrity failure: {e}")
        except (IndexError, ValueError) as e:
            return self._error(400, str(e))
        except (BrokenPipeError, ConnectionResetError):  # pragma: no cover
            pass  # client went away mid-response

    def _region(self, pool: VolumePool, name: str, query: str) -> None:
        roi = parse_qs(query).get("roi", [None])[0]
        if roi is None:
            return self._error(400, "region requires ?roi=, e.g. roi=8:40,:,16:32")
        # ETag revalidation runs BEFORE admission and decode: a repeated ROI
        # costs one hash, not a region decode
        etag, parsed = pool.region_etag(name, roi)
        inm = self.headers.get("If-None-Match")
        if inm is not None and (inm.strip() == "*"
                                or etag in (v.strip() for v in inm.split(","))):
            pool.metrics.record_not_modified(name)
            return self._send(304, b"", "application/x-npy", headers={"ETag": etag})
        block, meta = pool.region(name, parsed)
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(block))
        self._send(200, buf.getvalue(), "application/x-npy",
                   headers={"X-Repro-Meta": json.dumps(meta), "ETag": etag})


class _ThreadingServer(ThreadingHTTPServer):
    # non-daemon handler threads (the reference's are daemons): server_close()
    # joins them, so none is mid-launch when the interpreter tears CUDA down;
    # the handler's socket timeout bounds the wait on an idle keep-alive
    daemon_threads = False
    # hundreds of concurrent readers open sockets faster than handler
    # threads spawn; the default backlog of 5 would refuse them
    request_queue_size = 512


class RegionServer:
    """The daemon: a :class:`VolumePool` behind a ``ThreadingHTTPServer``.

    ``port=0`` binds an ephemeral port (read it back from ``.address``).
    ``start()`` serves on a daemon thread; the CLI's ``serve`` command
    waits on it.  :meth:`stop` shuts the listener, joins the handler
    threads and the serving thread, then closes the pool."""

    def __init__(self, volumes=None, *, host: str = "127.0.0.1", port: int = 0,
                 verbose: bool = False, **pool_kw):
        self.pool = volumes if isinstance(volumes, VolumePool) else VolumePool(volumes,
                                                                               **pool_kw)
        self._http = _ThreadingServer((host, port), _Handler)
        self._http.pool = self.pool
        self._http.verbose = verbose
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self._http.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "RegionServer":
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        name="repro-torch-serve", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._http.serve_forever()

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()  # joins the handler threads
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.pool.close()

    def __enter__(self) -> "RegionServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


def fetch_region(url: str, name: str, roi: str, timeout: float = 60.0,
                 etag: str | None = None):
    """Stdlib client: GET a region and parse the ``.npy`` payload.  Returns
    ``(array, meta)``, ``meta["etag"]`` the response's ETag; pass it back as
    ``etag=`` to revalidate, which returns ``(None, meta)`` on a 304.
    Raises ``RuntimeError`` with the server's message on other non-200s."""
    from urllib.error import HTTPError
    from urllib.request import Request, urlopen

    req = Request(f"{url}/v/{name}/region?roi={roi}")
    if etag is not None:
        req.add_header("If-None-Match", etag)
    try:
        with urlopen(req, timeout=timeout) as r:
            meta = json.loads(r.headers.get("X-Repro-Meta", "{}"))
            meta["etag"] = r.headers.get("ETag")
            arr = np.load(io.BytesIO(r.read()))
    except HTTPError as e:
        if e.code == 304:
            return None, {"etag": e.headers.get("ETag")}
        detail = e.read().decode(errors="replace").strip()
        raise RuntimeError(f"region {name!r} roi={roi!r}: HTTP {e.code}: {detail}") from None
    return arr, meta


def fetch_json(url: str, path: str, timeout: float = 60.0) -> dict:
    """GET a JSON endpoint (``/healthz``, ``/metrics``, ``/v/<n>/info``)."""
    from urllib.request import urlopen

    with urlopen(f"{url}{path}", timeout=timeout) as r:
        return json.loads(r.read())
