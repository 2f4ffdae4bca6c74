"""Port parity: the serving daemon (``repro_torch.serve``), its decode
batcher (``repro_torch.exec.cache.DecodeBatcher``) and ``cli serve``, on
the CPU.

The cases mirror ``tests/test_serve.py`` one by one.  Then the port's
daemon and the reference's ``repro.serve.RegionServer`` serve the same
Lorenzo containers (written by either package) and must return identical
``.npy`` bodies for the same ROI list, and equal ``info`` fields.  The two
deliberate differences are held as the port's own values: the admission
price (lanes x ``tile_working_bytes``, no bucket rounding) and the ETag's
codec token (the device type).
"""
import hashlib
import io
import threading
from urllib.request import urlopen

import numpy as np
import pytest

from repro import api as rapi
from repro import cli as rcli
from repro import serve as rserve
from repro_torch import api, cli
from repro_torch.data import nyx_like_field
from repro_torch.exec.cache import DecodeBatcher, TileCache
from repro_torch.exec.plan import tile_working_bytes
from repro_torch.serve import (
    AdmissionController,
    RegionServer,
    RequestRejected,
    VolumePool,
    fetch_json,
    fetch_region,
)
from repro_torch.sz import tiled

CPU = "cpu"


@pytest.fixture(scope="module")
def field():
    return np.asarray(nyx_like_field((24, 24, 24), "temperature", seed=5), np.float32)


@pytest.fixture(scope="module")
def tiled_vol(field):
    return api.compress(field, abs_eb=float(np.ptp(field)) * 1e-3, tiled=True,
                        tile=(8, 8, 8), predictor="lorenzo", device=CPU)


@pytest.fixture(scope="module")
def full(tiled_vol):
    return np.asarray(api.CompressedVolume(tiled_vol.artifact, device=CPU))


def _gwtc_path(tmp_path, vol, name="v.gwtc"):
    out = tmp_path / name
    api.save(out, vol)
    return out


def _pool(volumes=None, **kw):
    kw.setdefault("cache_bytes", 8 << 20)
    kw.setdefault("mem_budget", 8 << 20)
    return VolumePool(volumes, device=CPU, **kw)


def _run_threads(n, target):
    ts = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


# ---------------------------------------------------------------------------
# DecodeBatcher
# ---------------------------------------------------------------------------


def test_decode_batcher_coalesces_across_threads():
    """N concurrent single-lane submits to one volume collapse into ONE
    decode call: with ``max_batch_tiles == N`` the leader drains only once
    every submitter has arrived."""
    calls, out, lock = [], {}, threading.Lock()

    def decode(ids):
        with lock:
            calls.append(list(ids))
        return {i: i * 10 for i in ids}

    n = 8
    b = DecodeBatcher(max_wait_ms=5000.0, max_batch_tiles=n)
    gate = threading.Barrier(n)

    def worker(i):
        gate.wait()
        got = b.submit("vol", [i], decode)
        with lock:
            out[i] = got

    _run_threads(n, worker)
    assert len(calls) == 1 and sorted(calls[0]) == list(range(n))
    assert out == {i: {i: i * 10} for i in range(n)}
    assert b.dispatches == 1 and b.submits == n and b.coalesced_submits == n - 1
    assert b.pending_tiles == 0 and b.peak_pending_tiles == n
    assert b.info()["batch_hist"] == {str(n): 1}


def test_decode_batcher_propagates_leader_error():
    """A decode failure in the leader surfaces in EVERY submitter of the
    round, and the round leaks no queue depth."""

    def boom(ids):
        raise RuntimeError("lane decode failed")

    n = 4
    b = DecodeBatcher(max_wait_ms=5000.0, max_batch_tiles=n)
    gate = threading.Barrier(n)
    errs, lock = [], threading.Lock()

    def worker(i):
        gate.wait()
        try:
            b.submit("vol", [i], boom)
        except RuntimeError as e:
            with lock:
                errs.append(str(e))

    _run_threads(n, worker)
    assert len(errs) == n and all("lane decode failed" in e for e in errs)
    assert b.pending_tiles == 0


def test_decode_batcher_dedups_and_empty():
    seen = []

    def decode(ids):
        seen.append(list(ids))
        return {i: -i for i in ids}

    b = DecodeBatcher(max_wait_ms=0.0, max_batch_tiles=64)
    assert b.submit("v", [], decode) == {}
    assert b.submit("v", [3, 3, 5], decode) == {3: -3, 5: -5}
    assert seen == [[3, 5]], "duplicate lane ids must decode once"


def test_leader_error_reaches_every_reader_then_recovers(tiled_vol, full):
    """A decode error on the batch leader's thread reaches every concurrent
    reader of the round through the claims' abandon path (no hang, no
    partial tiles); the next reads decode normally."""
    vol = api.CompressedVolume(tiled_vol.artifact, tile_cache=TileCache(8 << 20),
                               decode_batcher=DecodeBatcher(max_wait_ms=5000.0,
                                                            max_batch_tiles=4),
                               device=CPU)
    real = vol.pipeline.decode_tiles
    fail = threading.Event()
    fail.set()

    def flaky(*a, **kw):
        if fail.is_set():
            raise RuntimeError("kernel launch failed")
        return real(*a, **kw)

    vol.pipeline.decode_tiles = flaky
    rois = [tuple(slice(8 * i, 8 * i + 8) for i in pos)
            for pos in ((0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0))]
    gate = threading.Barrier(len(rois))
    errs, lock = [], threading.Lock()

    def reader(i):
        gate.wait()
        try:
            vol[rois[i]]
        except RuntimeError as e:
            with lock:
                errs.append(str(e))

    _run_threads(len(rois), reader)
    assert errs == ["kernel launch failed"] * len(rois)
    assert vol.tile_cache.info()["inflight"] == 0 and len(vol.tile_cache) == 0
    fail.clear()
    for r in rois:
        np.testing.assert_array_equal(vol[r], full[r])


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def test_admission_budget_and_oversize():
    adm = AdmissionController(100, max_queue=8, timeout=5.0)
    adm.admit(60)
    done = threading.Event()

    def second():
        adm.admit(60)  # must wait: 120 > 100
        done.set()

    t = threading.Thread(target=second)
    t.start()
    assert not done.wait(0.15), "an over-budget request must queue"
    adm.release(60)
    assert done.wait(5), "release must wake the waiter"
    adm.release(60)
    t.join()
    adm.admit(10_000)  # oversize: admitted alone rather than deadlocking
    adm.release(10_000)
    assert adm.info()["inflight_bytes"] == 0


def test_admission_queue_full_rejects():
    adm = AdmissionController(10, max_queue=1, timeout=5.0)
    adm.admit(10)
    blocked = threading.Thread(target=lambda: (adm.admit(5), adm.release(5)))
    blocked.start()
    for _ in range(100):
        if adm.info()["queue_depth"] == 1:
            break
        threading.Event().wait(0.01)
    with pytest.raises(RequestRejected):
        adm.admit(5)
    assert adm.info()["rejected"] == 1
    adm.release(10)
    blocked.join()


def test_admission_cost_is_the_ports_own(tmp_path, tiled_vol, field):
    """The port prices lanes x tile_working_bytes with no bucket rounding (6
    lanes cost 6 tiles; the reference charges its width-8 bucket); the
    device encode's words count only on the card.  Monolithic: 3 x 4 bytes
    a value, as in the reference."""
    mono = api.compress(field, abs_eb=float(np.ptp(field)) * 1e-3, predictor="lorenzo",
                        device=CPU)
    pool = _pool({"v": _gwtc_path(tmp_path, tiled_vol), "m": _gwtc_path(tmp_path, mono, "m.sz")},
                 cache_bytes=1 << 20, mem_budget=32 << 20)
    with pool:
        art = pool.volume("v").artifact
        per = tile_working_bytes(art.tile, art.predictor, art.levels)
        assert per == tile_working_bytes(art.tile, art.predictor, art.levels,
                                         device_entropy=False)
        _block, meta = pool.region("v", "0:17,0:9,0:8")  # 3 x 2 x 1 lanes
        assert meta["lanes"] == 6 and meta["cost_bytes"] == 6 * per
        with rserve.VolumePool({"v": _gwtc_path(tmp_path, tiled_vol, "r.gwtc")},
                               cache_bytes=1 << 20, mem_budget=32 << 20) as rpool:
            assert rpool.region("v", "0:17,0:9,0:8")[1]["cost_bytes"] == 8 * per
        assert pool.region("m", "0:4")[1]["cost_bytes"] == 3 * field.size * 4


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


def test_pool_region_info_metrics(tmp_path, tiled_vol, full):
    pool = _pool({"nyx": _gwtc_path(tmp_path, tiled_vol)})
    with pool:
        block, meta = pool.region("nyx", "0:12,:,4:20")
        np.testing.assert_array_equal(block, full[0:12, :, 4:20])
        lanes = api.region_lane_count(pool.volume("nyx"),
                                      (slice(0, 12), slice(None), slice(4, 20)))[0]
        assert meta["lanes"] == lanes and meta["lanes_total"] == 27
        pool.region("nyx", "0:12,:,4:20")  # repeat: all hits
        assert pool.info("nyx")["stats"]["cache_hits"] >= lanes
        m = pool.metrics_snapshot()
        assert m["requests"] == 2 and m["cache"]["hit_rate"] > 0
        assert m["latency_ms"]["count"] == 2
        assert m["volumes"]["nyx"]["tiles_decoded"] == lanes
        with pytest.raises(KeyError, match="no volume"):
            pool.region("nope", "0:4")
        with pytest.raises(ValueError):
            pool.add_volume("nyx", _gwtc_path(tmp_path, tiled_vol))


@pytest.mark.parametrize("batch_wait_ms", [1.0, None], ids=["batcher", "no_batcher"])
def test_pool_batcher_and_decode_counters(tmp_path, tiled_vol, full, batch_wait_ms):
    """With a batcher the pool's decodes go through it and /metrics shows
    it; without (``--no-batcher``) the same bytes and no batcher block.
    The decode counters count one dispatch per decode batch, keyed by its
    size."""
    pool = _pool({"v": _gwtc_path(tmp_path, tiled_vol)}, batch_wait_ms=batch_wait_ms)
    with pool:
        assert (pool.batcher is None) == (batch_wait_ms is None)
        tiled.reset_dispatch_stats()
        block, meta = pool.region("v", "0:17,0:9,0:8")
        np.testing.assert_array_equal(block, full[0:17, 0:9, 0:8])
        m = pool.metrics_snapshot()
        assert m["decode"] == {"dispatches": 1, "batch_hist": {"6": 1}}
        if batch_wait_ms is None:
            assert "batcher" not in m
        else:
            assert m["batcher"]["dispatches"] == 1 and m["batcher"]["submits"] == 1


# ---------------------------------------------------------------------------
# the daemon over HTTP
# ---------------------------------------------------------------------------


def test_daemon_concurrent_http_bit_equal(tmp_path, tiled_vol, full):
    """Concurrent clients fetching overlapping ROIs over real HTTP get bytes
    equal to ``full[roi]``, also from an ``on_corrupt="quarantine"`` volume
    in the same pool, while the shared cache reports a true hit rate."""
    good = _gwtc_path(tmp_path, tiled_vol, "good.gwtc")
    blob = bytearray(good.read_bytes())
    blob[tiled.lane_offset(tiled_vol.artifact, 0) + 7] ^= 0x10  # a bit of lane 0
    bad = tmp_path / "bad.gwtc"
    bad.write_bytes(bytes(blob))
    pool = _pool(cache_bytes=16 << 20, mem_budget=16 << 20, on_corrupt="quarantine",
                 fill_value=-7.0)
    pool.add_volume("good", good)
    pool.add_volume("quar", bad)
    with api.open(bad, on_corrupt="quarantine", fill_value=-7.0, device=CPU) as ref:
        quar_full = np.asarray(ref).copy()
    assert np.all(quar_full[:8, :8, :8] == -7.0)
    errors = []
    gate = threading.Barrier(8)

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            gate.wait()
            for _ in range(6):
                lo = rng.integers(0, 16, 3)
                hi = lo + rng.integers(4, 12, 3)
                roi = ",".join(f"{a}:{min(int(b), 24)}" for a, b in zip(lo, hi))
                sl = tuple(slice(*map(int, t.split(":"))) for t in roi.split(","))
                name, want = ("good", full) if seed % 2 else ("quar", quar_full)
                arr, meta = fetch_region(server.url, name, roi)
                np.testing.assert_array_equal(arr, want[sl])
                assert meta["lanes_total"] == 27
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    with RegionServer(pool) as server:
        _run_threads(8, client)
        assert not errors, errors[0]
        assert fetch_json(server.url, "/healthz") == {"status": "ok",
                                                      "volumes": ["good", "quar"]}
        m = fetch_json(server.url, "/metrics")
        assert m["requests"] == 48 and m["errors"] == 0
        assert m["cache"]["hit_rate"] > 0, "overlapping ROIs must share"
        assert m["volumes"]["quar"]["quarantined"] == 1
        assert m["latency_ms"]["p99"] >= m["latency_ms"]["p50"]
        with pytest.raises(RuntimeError, match="404"):
            fetch_region(server.url, "nope", "0:4")
        with pytest.raises(RuntimeError, match="400"):
            fetch_region(server.url, "good", "banana")
        with pytest.raises(RuntimeError, match="400"):
            fetch_region(server.url, "good", "3,:,:")  # an integer axis has no range
        assert fetch_json(server.url, "/v/good/info")["n_lanes"] == 27
    assert len(pool.names) == 0, "stopping the server closes the pool"


def _port_etag(pool, name, canon):
    """The port's ETag: the reference's recipe with the device type as the
    codec token."""
    seed = pool._etag_seed(name, pool.volume(name))
    return '"' + hashlib.sha1(f"{seed}|{canon}|cpu".encode()).hexdigest()[:32] + '"'


def test_pool_region_etag_canonical(tmp_path, tiled_vol):
    """Equivalent ROI spellings revalidate each other, different regions
    never collide, and the token is the port's (the device type)."""
    pool = _pool({"nyx": _gwtc_path(tmp_path, tiled_vol)}, cache_bytes=1 << 20)
    with pool:
        e1, _ = pool.region_etag("nyx", "0:8,0:8,0:8")
        assert pool.region_etag("nyx", ":8,:8,:8")[0] == e1
        assert pool.region_etag("nyx", "0:8,0:8,0:8")[0] == e1
        assert e1 == _port_etag(pool, "nyx", ((0, 8), (0, 8), (0, 8)))
        assert pool.region_etag("nyx", "8:16,0:8,0:8")[0] != e1
        with pytest.raises(KeyError):
            pool.region_etag("nope", "0:4")


def test_daemon_etag_304_skips_decode(tmp_path, tiled_vol, full):
    """Revalidating with the returned ETag answers 304 with no decode: the
    decode counters and tiles_decoded stay, no latency sample is taken."""
    pool = _pool({"nyx": _gwtc_path(tmp_path, tiled_vol)})
    with RegionServer(pool) as srv:
        arr1, meta1 = fetch_region(srv.url, "nyx", "0:8,8:16,0:8")
        np.testing.assert_array_equal(arr1, full[0:8, 8:16, 0:8])
        m1 = fetch_json(srv.url, "/metrics")
        arr2, meta2 = fetch_region(srv.url, "nyx", "0:8,8:16,0:8", etag=meta1["etag"])
        assert arr2 is None and meta2["etag"] == meta1["etag"]
        assert fetch_region(srv.url, "nyx", ":8,8:16,:8", etag=meta1["etag"])[0] is None
        m2 = fetch_json(srv.url, "/metrics")
        assert m2["not_modified"] == 2 and m2["requests"] == m1["requests"] + 2
        assert m2["volumes"]["nyx"]["tiles_decoded"] == m1["volumes"]["nyx"]["tiles_decoded"]
        assert m2["decode"]["dispatches"] == m1["decode"]["dispatches"], "304 must not decode"
        assert m2["latency_ms"]["count"] == m1["latency_ms"]["count"]
        arr4, meta4 = fetch_region(srv.url, "nyx", "8:16,8:16,0:8", etag=meta1["etag"])
        np.testing.assert_array_equal(arr4, full[8:16, 8:16, 0:8])
        assert meta4["etag"] != meta1["etag"]


# ---------------------------------------------------------------------------
# the port's daemon against the reference's
# ---------------------------------------------------------------------------

PARITY_ROIS = ["0:8,0:8,0:8", ":8,:8,:8", "3:21,5:19,0:24", "0:24,0:24,0:24",
               "7:9,7:9,7:9", "16:24,0:3,10:11"]


def _raw_region(url, name, roi) -> bytes:
    with urlopen(f"{url}/v/{name}/region?roi={roi}", timeout=60) as r:
        return r.read()


@pytest.mark.parametrize("container", ["gwtc", "szjx"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_daemon_matches_the_reference(tmp_path, field, container, writer):
    """For a Lorenzo container written by either package, the port's daemon
    and the reference's return byte-identical ``.npy`` bodies for the same
    ROIs and equal ``info``; the ETag and the price are the port's own."""
    kw = dict(abs_eb=float(np.ptp(field)) * 1e-3, tiled=container == "gwtc", tile=(8, 8, 8),
              predictor="lorenzo")
    path = tmp_path / f"f.{container}"
    if writer == "port":
        api.save(path, api.compress(field, device=CPU, **kw))
    else:
        rapi.save(path, rapi.compress(field, **kw))
    with RegionServer({"f": path}, device=CPU, cache_bytes=1 << 20) as port, \
            rserve.RegionServer({"f": path}, cache_bytes=1 << 20) as ref:
        for roi in PARITY_ROIS:
            assert _raw_region(port.url, "f", roi) == _raw_region(ref.url, "f", roi), roi
        assert fetch_json(port.url, "/v/f/info") == fetch_json(ref.url, "/v/f/info")
        _arr, meta = fetch_region(port.url, "f", PARITY_ROIS[2])
        canon = ((3, 21), (5, 19), (0, 24))
        assert meta["etag"] == _port_etag(port.pool, "f", canon)
        assert meta["etag"] != fetch_region(ref.url, "f", PARITY_ROIS[2])[1]["etag"]
        vol = port.pool.volume("f")
        want = (meta["lanes"] * tile_working_bytes((8, 8, 8), "lorenzo", 0)
                if container == "gwtc" else 3 * field.size * 4)
        assert meta["cost_bytes"] == want and vol.device.type == "cpu"


# ---------------------------------------------------------------------------
# CLI: exit codes (0 ok / 1 integrity / 2 usage) and serve --smoke
# ---------------------------------------------------------------------------


def _exit_code(argv) -> int:
    try:
        rc = cli.main(["--device", CPU, *argv])
    except SystemExit as e:
        return int(e.code or 0)
    return int(rc or 0)


def test_cli_usage_errors_exit_2(tmp_path, tiled_vol):
    out = _gwtc_path(tmp_path, tiled_vol)
    assert _exit_code(["region", str(tmp_path / "missing.gwtc"), "--roi", "0:4"]) == 2
    assert _exit_code(["region", str(out), "--roi", "banana"]) == 2
    assert _exit_code(["decompress", str(tmp_path / "missing.gwtc"),
                       str(tmp_path / "o.npy")]) == 2
    assert _exit_code(["compress", str(tmp_path / "missing.npy"), str(tmp_path / "o.gwtc"),
                       "--eb", "1e-3"]) == 2
    assert _exit_code(["compress", "synthetic:temperature:8", str(tmp_path / "o.gwtc"),
                       "--eb", "1e-3", "--resume"]) == 2
    # a valid GWDS dataset is not a volume: the pool's ValueError is a usage
    # error here (the reference's CLI lets the same ValueError escape)
    gwds = tmp_path / "d.gwds"
    api.save(gwds, {"t": tiled_vol})
    assert _exit_code(["serve", f"d={gwds}", "--port", "0", "--smoke"]) == 2


def test_pool_refuses_a_gwds_dataset_as_the_reference_does(tmp_path, tiled_vol):
    gwds = tmp_path / "d.gwds"
    api.save(gwds, {"t": tiled_vol})
    with pytest.raises(ValueError) as port:
        VolumePool({"d": str(gwds)}, device=CPU)
    with pytest.raises(ValueError) as ref:
        rserve.VolumePool({"d": str(gwds)})
    assert str(port.value) == str(ref.value)
    assert "is a GWDS dataset; register each field as its own volume" in str(port.value)
    # a field of the dataset, opened and passed as a handle, serves
    with api.open(gwds, device=CPU) as ds:
        pool = VolumePool({"t": ds["t"]}, device=CPU)
        np.testing.assert_array_equal(pool.region("t", "0:4,0:8,0:8")[0],
                                      np.asarray(tiled_vol)[0:4, 0:8, 0:8])
        pool.close()


def test_cli_serve_corrupt_gwds_is_an_integrity_error(tmp_path, capsys):
    """A damaged envelope fails with its own error before the dataset check,
    in both packages: CORRUPT, exit 1."""
    gwds = tmp_path / "z.gwds"
    gwds.write_bytes(b"GWDS" + bytes(12))
    argv = ["serve", f"z={gwds}", "--port", "0", "--smoke"]
    assert _exit_code(argv) == 1
    port_err = capsys.readouterr().err
    try:
        ref_rc = rcli.main(argv)
    except SystemExit as e:
        ref_rc = e.code
    assert ref_rc == 1 and port_err == capsys.readouterr().err
    assert port_err.startswith("CORRUPT: unsupported GWDS version")


def test_cli_integrity_errors_exit_1(tmp_path, tiled_vol):
    out = _gwtc_path(tmp_path, tiled_vol)
    blob = bytearray(out.read_bytes())
    blob[tiled.lane_offset(tiled_vol.artifact, 0) + 5] ^= 0x10
    bad = tmp_path / "bad.gwtc"
    bad.write_bytes(bytes(blob))
    assert _exit_code(["verify", str(bad)]) == 1
    assert _exit_code(["region", str(bad), "--roi", "0:8,0:8,0:8"]) == 1
    assert _exit_code(["verify", str(out)]) == 0
    assert _exit_code(["region", str(out), "--roi", "0:8,0:8,0:8"]) == 0
    trunc = tmp_path / "trunc.gwtc"
    trunc.write_bytes(out.read_bytes()[:40])
    assert _exit_code(["serve", f"t={trunc}", "--port", "0", "--smoke"]) == 1


def test_cli_serve_smoke_and_usage(tmp_path, tiled_vol, capsys):
    out = _gwtc_path(tmp_path, tiled_vol, "nyx.gwtc")
    assert _exit_code(["serve", f"v={out}", "--port", "0", "--smoke"]) == 0
    text = capsys.readouterr().out
    assert "smoke ok" in text and "hit_rate" in text and "device cpu" in text
    assert _exit_code(["serve", str(out), "--port", "0", "--smoke", "--no-batcher"]) == 0
    assert "serving ['nyx']" in capsys.readouterr().out  # default name: the file stem
    assert _exit_code(["serve", f"a={out}", f"a={out}", "--port", "0"]) == 2
    assert _exit_code(["serve", str(tmp_path / "missing.gwtc"), "--port", "0"]) == 2
    assert _exit_code(["serve", f"v={out}", "--port", "0", "--cache-bytes", "banana"]) == 2


def test_cli_serve_without_a_card_is_a_usage_error(tmp_path, tiled_vol, monkeypatch):
    """``--device cuda`` (the default) with no CUDA device exits 2."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = _gwtc_path(tmp_path, tiled_vol)
    try:
        rc = cli.main(["serve", f"v={out}", "--port", "0", "--smoke"])
    except SystemExit as e:
        rc = e.code
    assert rc == 2


def test_npy_body_is_numpys(tmp_path, tiled_vol, full):
    """The region body is ``np.save`` of the block: it loads back exactly."""
    with RegionServer({"v": _gwtc_path(tmp_path, tiled_vol)}, device=CPU) as srv:
        body = _raw_region(srv.url, "v", "1:9,2:20,3:4")
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(full[1:9, 2:20, 3:4]))
    assert body == buf.getvalue()
