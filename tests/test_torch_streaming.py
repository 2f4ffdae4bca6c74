"""Port parity: the out-of-core streaming execution layer
(``repro_torch.exec``: sources, plan, executor; the reservoir-trained
enhancers of ``repro_torch.core.trainer``), against ``repro.exec`` on the
CPU.

* Lorenzo streams are byte-identical to the reference's stream and to the
  port's eager ``compress_tiled``, for array, ``.npy`` and iterator
  sources, with several batches and a short, padded final one.
* The plan geometry, ``StreamReport`` geometry, tracked peak and eb equal
  the reference's; the relative-eb prepass gives the eager eb bit for bit.
* A streamed interp container equals the port's eager one bit for bit and
  holds ``max|x - x'| <= float32(eb)`` exactly; against the reference it
  stays within ``tests/test_torch_interp.py``'s bounds (TOL = 8 eps max|x|,
  eps = 2**-23, and >= 99.9% equal codes).
* The reservoir samples the same tiles as the reference, bit for bit; the
  streamed enhancer's decode meets ``tests/test_torch_gwlz.py``'s tolerance
  (1e-5 eb + 1 spacing(x) per value) across packages.
"""
import os
import time

import numpy as np
import pytest
import torch

from repro import api as rapi
from repro import exec as rexec
from repro.core import trainer as rtrainer
from repro_torch import api, cli
from repro_torch.core import trainer as ptrainer
from repro_torch.core.trainer import GWLZTrainConfig, TileReservoir
from repro_torch.data import nyx_like_field
from repro_torch.exec import (
    ArraySource,
    GWTCWriter,
    IterSource,
    NpyFileSource,
    as_source,
    max_inflight_tiles,
    plan_stream,
    stream_compress,
    tile_working_bytes,
)
from repro_torch.exec.sources import value_range
from repro_torch.sz import predictor as P
from repro_torch.sz import quantizer as Q
from repro_torch.sz import tiled as PT

CPU = "cpu"
EPS = 2.0**-23
TILE = (16, 16, 16)
# 40^3 in 16^3 tiles: 27 tiles.  Lorenzo: 5 a batch -> 6 batches, the last
# of 2 (padded to 5).  Interp: 12 a batch -> 3 batches, the last of 3.
LOR = dict(abs_eb=1e-3, tile=TILE, mem_budget=10 * 12 * 16**3, predictor="lorenzo")
INT = dict(abs_eb=1e-3, tile=TILE, mem_budget=2_000_000, predictor="interp")
# the enhanced stream: 24^3 in 8^3 tiles from a slab iterator, 12 a batch (3
# batches, the last of 3), a 9-tile reservoir
ENH = dict(abs_eb=1e-3, tile=(8, 8, 8), mem_budget=150_000, predictor="lorenzo")
ENH_CFG = dict(n_groups=2, epochs=2, batch_size=4, min_group_pixels=16)
ROI = (slice(4, 20), slice(3, 9), slice(0, 40))


@pytest.fixture(scope="module")
def field():
    x = nyx_like_field((40, 40, 40), "temperature", seed=5)
    return x / np.float32(np.abs(x).max())


def _ref_run(field, out, **kw):
    rep = rexec.stream_compress(field, str(out), **kw)
    return rep, out.read_bytes()


@pytest.fixture(scope="module")
def ref_lorenzo(field, tmp_path_factory):
    return _ref_run(field, tmp_path_factory.mktemp("rl") / "x.gwtc", **LOR)


@pytest.fixture(scope="module")
def ref_interp(field, tmp_path_factory):
    return _ref_run(field, tmp_path_factory.mktemp("ri") / "x.gwtc", **INT)


def _slabs(field):
    return (field[i : i + 8] for i in range(0, field.shape[0], 8))


def _spy_offers(monkeypatch, cls, seen):
    orig = cls.offer

    def offer(self, recon, resid):
        seen.append((np.array(recon), np.array(resid)))
        return orig(self, recon, resid)

    monkeypatch.setattr(cls, "offer", offer)


@pytest.fixture(scope="module")
def small():
    x = nyx_like_field((24, 24, 24), "temperature", seed=5)
    return x / np.float32(np.abs(x).max())


@pytest.fixture(scope="module")
def enhanced(small, tmp_path_factory):
    """Both packages' enhanced streams, with the tile pairs each executor
    offered to its reservoir."""
    field = small
    d = tmp_path_factory.mktemp("enh")
    offers = {"ref": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        _spy_offers(mp, rtrainer.TileReservoir, offers["ref"])
        _spy_offers(mp, ptrainer.TileReservoir, offers["port"])
        rrep = rapi.compress_stream(_slabs(field), str(d / "ref.gwtc"), shape=field.shape,
                                    enhance=rtrainer.GWLZTrainConfig(**ENH_CFG), **ENH)
        prep = api.compress_stream(_slabs(field), str(d / "port.gwtc"), shape=field.shape,
                                   enhance=GWLZTrainConfig(**ENH_CFG), device=CPU, **ENH)
    return {"ref": (rrep, d / "ref.gwtc"), "port": (prep, d / "port.gwtc"), "offers": offers}


def _eager(field, **kw):
    art, _ = PT.compress_tiled(field, kw["tile"], abs_eb=kw.get("abs_eb"),
                               rel_eb=kw.get("rel_eb"), predictor=kw["predictor"], device=CPU)
    return art.to_bytes()


# ---------------------------------------------------------------------------
# sources: Lorenzo bytes == the reference's stream == the port's eager path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["array", "npy", "memmap", "iterator"])
def test_streamed_lorenzo_bytes_equal_reference_and_eager(tmp_path, field, ref_lorenzo, kind):
    src = field
    if kind in ("npy", "memmap"):
        path = tmp_path / "src.npy"
        np.save(path, field)
        src = str(path) if kind == "npy" else np.load(path, mmap_mode="r")
    elif kind == "iterator":
        src = _slabs(field)
    out = tmp_path / "out.gwtc"
    rep = stream_compress(src, str(out), shape=field.shape, device=CPU, **LOR)
    assert rep.n_batches == 6 and rep.batch_tiles == 5, "several batches, a short final one"
    assert rep.nbytes == os.path.getsize(out)
    assert out.read_bytes() == ref_lorenzo[1]
    assert out.read_bytes() == _eager(field, **LOR)
    with api.open(out, device=CPU) as vol:
        full = np.asarray(vol)
        np.testing.assert_array_equal(vol[ROI], full[ROI])
        assert np.max(np.abs(full - field)) <= vol.eb_abs * (1 + 1e-6)


def test_source_reads_match_the_reference(tmp_path, field):
    path = tmp_path / "src.npy"
    np.save(path, field)
    ours = [ArraySource(field), NpyFileSource(path), as_source(str(path)), as_source(field)]
    refs = [rexec.ArraySource(field), rexec.NpyFileSource(path)]
    for lo, hi in (((0, 0, 0), (16, 16, 16)), ((32, 16, 0), (40, 32, 16)),
                   ((5, 7, 9), (6, 23, 12))):
        want = refs[0].read_tile(lo, hi, TILE)
        assert want.shape == TILE
        for src in ours + refs[1:]:
            np.testing.assert_array_equal(src.read_tile(lo, hi, TILE), want)
    assert value_range(ours[1]) == rexec.sources.value_range(refs[1]) \
        == (float(field.min()), float(field.max()))
    for src in ours + refs:
        src.close()


def test_iter_source_window_and_errors(field):
    src = IterSource(iter([field[:16], field[16:24], field[24:]]), field.shape)
    np.testing.assert_array_equal(src.read_block((0, 0, 0), (8, 40, 40)), field[:8])
    np.testing.assert_array_equal(src.read_block((16, 4, 8), (24, 9, 13)),
                                  field[16:24, 4:9, 8:13])
    with pytest.raises(ValueError, match="backwards"):
        src.read_block((0, 0, 0), (8, 40, 40))
    with pytest.raises(ValueError, match="exhausted"):
        IterSource(iter([field[:8]]), field.shape).read_block((8, 0, 0), (16, 40, 40))
    with pytest.raises(ValueError, match="does not match"):
        IterSource(iter([field[:8, :20]]), field.shape).read_block((0, 0, 0), (8, 40, 40))
    with pytest.raises(ValueError, match="shape="):
        as_source(iter([field]))
    with pytest.raises(ValueError, match=".npy"):
        as_source("volume.h5")
    with pytest.raises(TypeError, match="cannot stream"):
        as_source(42)
    with pytest.raises(ValueError, match="abs_eb"):
        value_range(IterSource(iter([field]), field.shape))


# ---------------------------------------------------------------------------
# plan and report geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("predictor,tile,budget,dev_entropy", [
    ("lorenzo", (16, 16, 16), 10 * 12 * 16**3, False),
    ("lorenzo", (64, 64, 64), 256 << 20, True),
    ("interp", (16, 16, 16), 2_000_000, False),
    ("interp", (64, 64, 64), 256 << 20, True),
    ("lorenzo", (8, 8, 8), 1, False),
])
def test_plan_geometry_matches_the_reference(predictor, tile, budget, dev_entropy):
    """Including the H100 run's geometry: 64^3 tiles of 512^3 under 256 MiB
    with device entropy, 32 Lorenzo tiles a batch (16 batches) and 23
    interp tiles (23 batches)."""
    shape = (512, 512, 512) if tile == (64, 64, 64) else (40, 40, 40)
    levels = P.get_predictor(predictor).plan(tile, 5)
    kw = dict(predictor=predictor, levels=levels, device_entropy=dev_entropy)
    plan = plan_stream(shape, tile, budget, **kw)
    want = rexec.plan_stream(shape, tile, budget, devices=1, **kw)
    assert plan == type(plan)(**{f: getattr(want, f) for f in plan.__dataclass_fields__})
    assert plan.n_batches == want.n_batches
    assert [list(r) for r in plan.batches()] == [list(r) for r in want.batches()]
    assert tile_working_bytes(tile, predictor, levels, device_entropy=dev_entropy) == \
        rexec.tile_working_bytes(tile, predictor, levels, device_entropy=dev_entropy)
    assert max_inflight_tiles(budget, tile, predictor=predictor, levels=levels) == \
        rexec.max_inflight_tiles(budget, tile, predictor=predictor, levels=levels)
    if tile == (64, 64, 64):
        assert (plan.batch_tiles, plan.n_batches) == \
            ((32, 16) if predictor == "lorenzo" else (23, 23))
    if budget == 1:
        assert plan.batch_tiles == 1, "a starved budget still makes progress"


REPORT_FIELDS = ("shape", "tile", "n_tiles", "n_batches", "batch_tiles", "nbytes", "eb_abs",
                 "predictor", "backend", "mem_budget", "peak_tracked_bytes", "enhanced",
                 "reservoir_tiles", "retries", "failed_batches", "resumed_batches",
                 "entropy_device")


class _Slow:
    """An injector that never fails, only waits: it fixes which stage of the
    two-stage loop finishes first."""

    def __init__(self, seconds: float):
        self.seconds = seconds

    def maybe_fail(self, _step) -> None:
        time.sleep(self.seconds)


@pytest.mark.parametrize("predictor", ["lorenzo", "interp"])
@pytest.mark.parametrize("slower", ["device", "host"])
def test_stream_report_matches_the_reference(tmp_path, field, predictor, slower):
    """The report's geometry, eb and tracked peak equal the reference's.

    The tracked peak depends on thread timing in both packages: it counts
    batch k-1's payload too when the host stage still holds it as batch k's
    payload lands.  A waiting injector fixes that order (a slow device
    stage: batch + payload; a slow host stage: batch + two payloads)."""
    kw = LOR if predictor == "lorenzo" else INT
    wait = dict(injector=_Slow(0.1)) if slower == "device" else \
        dict(write_injector=_Slow(0.02))
    rep = stream_compress(field, str(tmp_path / "x.gwtc"), device=CPU, **kw, **wait)
    rrep = rexec.stream_compress(field, str(tmp_path / "r.gwtc"), **kw, **wait)
    fields = REPORT_FIELDS if predictor == "lorenzo" else \
        tuple(f for f in REPORT_FIELDS if f != "nbytes")  # interp floats: own bytes
    assert {f: getattr(rep, f) for f in fields} == {f: getattr(rrep, f) for f in fields}
    t = int(np.prod(TILE))
    payload = rep.batch_tiles * (4 * t if predictor == "lorenzo"
                                 else 9 * int(np.prod(P._padded_shape(TILE, P.get_predictor("interp").plan(TILE)))))
    batch = rep.batch_tiles * 4 * t
    assert rep.peak_tracked_bytes == batch + payload * (1 if slower == "device" else 2)
    assert rep.peak_tracked_bytes <= 2 * rep.mem_budget
    assert rep.programs_compiled == 0 and rep.entropy_device is False
    assert rep.host_stage_s > 0 and rep.ru_maxrss_kb > 0
    assert rep.peak_over_budget == rep.peak_tracked_bytes / rep.mem_budget


def test_rel_eb_prepass_matches_eager_bit_for_bit(tmp_path, field):
    x = nyx_like_field((33, 40, 29), "velocity_x", seed=2)  # signed, off-grid sizes
    kw = dict(rel_eb=1e-3, tile=TILE, mem_budget=200_000, predictor="lorenzo")
    out = tmp_path / "x.gwtc"
    rep = stream_compress(x, str(out), device=CPU, **kw)
    rrep = rexec.stream_compress(x, str(tmp_path / "r.gwtc"), **kw)
    eager_eb = Q.resolve_eb(torch.from_numpy(x), 1e-3, None)
    assert rep.eb_abs == eager_eb == rrep.eb_abs
    assert out.read_bytes() == _eager(x, **kw) == (tmp_path / "r.gwtc").read_bytes()
    via_api = tmp_path / "a.gwtc"
    api.compress_stream(x, via_api, eb=1e-3, tile=TILE, mem_budget=200_000, device=CPU)
    assert via_api.read_bytes() == out.read_bytes()


# ---------------------------------------------------------------------------
# interp
# ---------------------------------------------------------------------------


def _lane_codes(blob, tile, levels):
    return np.concatenate([
        P.get_predictor("interp").parse_lane(bytes(b), tile=tile, levels=levels,
                                             device=torch.device(CPU))["codes"].numpy().ravel()
        for b in PT.TiledCompressed.from_bytes(blob).tile_blobs])


def test_streamed_interp_equals_port_eager_and_holds_the_bound(tmp_path, field, ref_interp):
    out = tmp_path / "x.gwtc"
    rep = stream_compress(field, str(out), device=CPU, **INT)
    assert rep.n_batches == 3 and rep.batch_tiles == 12
    blob = out.read_bytes()
    assert blob == _eager(field, **INT)
    with api.open(out, device=CPU) as vol:
        full = np.asarray(vol)
        assert np.max(np.abs(full.astype(np.float64) - field)) <= float(np.float32(vol.eb_abs))
        np.testing.assert_array_equal(vol[ROI], full[ROI])
    # against the reference: tests/test_torch_interp.py's bounds
    rblob = ref_interp[1]
    tol = 8 * EPS * float(np.abs(field).max())
    part, rart = PT.TiledCompressed.from_bytes(blob), PT.TiledCompressed.from_bytes(rblob)
    assert (part.shape, part.tile, part.eb_abs, part.levels, part.order) == \
        (rart.shape, rart.tile, rart.eb_abs, rart.levels, rart.order)
    with rapi.from_bytes(rblob) as rvol:
        rfull = np.asarray(rvol)
    with api.from_bytes(rblob, device=CPU) as pvol:
        assert np.max(np.abs(np.asarray(pvol).astype(np.float64) - rfull)) <= tol
    with rapi.from_bytes(blob) as rvol:
        assert np.max(np.abs(np.asarray(rvol).astype(np.float64) - field)) <= \
            rvol.eb_abs + tol
    codes = _lane_codes(blob, part.tile, part.levels)
    rcodes = _lane_codes(rblob, part.tile, part.levels)
    assert np.mean(codes == rcodes) >= 0.999


# ---------------------------------------------------------------------------
# reservoir and the streamed enhancer
# ---------------------------------------------------------------------------


def test_tile_reservoir_equals_the_reference_bit_for_bit():
    rng = np.random.default_rng(11)
    for cap, seed in ((8, 0), (3, 7), (50, 1)):
        ours, ref = TileReservoir(cap, seed=seed), rtrainer.TileReservoir(cap, seed=seed)
        for _ in range(20):
            rec = rng.normal(size=(int(rng.integers(1, 6)), 2, 3, 2)).astype(np.float32)
            res = rng.normal(size=rec.shape).astype(np.float32)
            assert ours.offer(rec, res) == ref.offer(rec, res)
        assert (len(ours), ours.n_seen, ours.nbytes) == (len(ref), ref.n_seen, ref.nbytes)
        for a, b in zip(ours.stacks(), ref.stacks()):
            assert a.dtype == np.float32 and np.array_equal(a, b)


def test_tile_reservoir_uniform_and_bounded():
    res = TileReservoir(8, seed=0)
    grown = res.offer(np.zeros((4, 2, 2, 2), np.float32), np.zeros((4, 2, 2, 2), np.float32))
    assert grown == 4 * 2 * 8 * 4  # 4 pairs of 8-voxel f32 tiles
    for i in range(20):
        res.offer(np.full((5, 2, 2, 2), i, np.float32), np.zeros((5, 2, 2, 2), np.float32))
    assert len(res) == 8 and res.n_seen == 104
    recon, resid = res.stacks()
    assert recon.shape == (8, 2, 2, 2) and resid.shape == recon.shape
    with pytest.raises(ValueError, match="capacity"):
        TileReservoir(0)
    with pytest.raises(ValueError, match="empty reservoir"):
        TileReservoir(2).stacks()
    with pytest.raises(ValueError, match="mismatch"):
        res.offer(np.zeros((1, 2)), np.zeros((1, 3)))


def test_streamed_reservoir_sees_the_references_tiles(enhanced):
    """The executor offers the reference's (recon, residual) pairs batch by
    batch, so the reservoir keeps the same tiles."""
    offers = enhanced["offers"]
    assert len(offers["port"]) == len(offers["ref"]) == 3  # 27 tiles, 12 a batch
    for (pr, pres), (rr, rres) in zip(offers["port"], offers["ref"]):
        assert np.array_equal(pr, rr) and np.array_equal(pres, rres)
    prep, rrep = enhanced["port"][0], enhanced["ref"][0]
    assert prep.enhanced and rrep.enhanced
    assert prep.reservoir_tiles == rrep.reservoir_tiles == 9
    assert prep.peak_tracked_bytes <= 2 * prep.mem_budget


def test_streamed_enhancer_decodes_within_tolerance(small, enhanced):
    """Each package decodes the other's streamed enhanced container within
    1e-5 eb + 1 spacing(x) of the other's own decode; the SZ lanes are
    byte-identical; in the port, ROI == crop and the model really applied."""
    (_, ppath), (_, rpath) = enhanced["port"], enhanced["ref"]
    part, rart = (PT.TiledCompressed.from_bytes(p.read_bytes()) for p in (ppath, rpath))
    assert [bytes(b) for b in part.tile_blobs] == [bytes(b) for b in rart.tile_blobs]
    for path in (ppath, rpath):
        with api.open(path, device=CPU) as pvol, rapi.open(path) as rvol:
            assert pvol.enhanced and rvol.enhanced
            got, want = np.asarray(pvol), np.asarray(rvol)
            assert (np.abs(got - want) <= 1e-5 * pvol.eb_abs + np.spacing(np.abs(small))).all()
            roi = (slice(3, 11), slice(0, 24), slice(2, 9))
            np.testing.assert_array_equal(pvol[roi], got[roi])
            raw = PT.decompress_tiled(pvol.artifact, device=CPU).numpy()
            assert not np.array_equal(got, raw), "the enhancer must change the decode"


def test_train_enhancers_streamed_equals_tiled_training(field):
    """Streamed training is tiled training on the reservoir's stacks."""
    rng = np.random.default_rng(4)
    res = TileReservoir(6, seed=0)
    rec = field[:32, :8, :8].reshape(4, 8, 8, 8).copy()
    res.offer(rec, rng.normal(0, 1e-3, rec.shape).astype(np.float32))
    cfg = GWLZTrainConfig(**ENH_CFG)
    model, hist = ptrainer.train_enhancers_streamed(res, cfg, device=CPU)
    recon, resid = res.stacks()
    want, whist = ptrainer.train_enhancers_tiled(torch.from_numpy(recon),
                                                 torch.from_numpy(resid), cfg, device=CPU)
    assert torch.equal(model.packed(), want.packed())
    assert np.array_equal(hist["loss"], whist["loss"])
    with pytest.raises(ValueError, match="empty reservoir"):
        ptrainer.train_enhancers_streamed(TileReservoir(2), cfg, device=CPU)


# ---------------------------------------------------------------------------
# errors and destinations
# ---------------------------------------------------------------------------


def test_iterator_source_requires_abs_eb(field, tmp_path):
    for run in (lambda: stream_compress(iter([field]), str(tmp_path / "p.gwtc"), rel_eb=1e-3,
                                        tile=(8, 8, 8), shape=field.shape, device=CPU),
                lambda: rexec.stream_compress(iter([field]), str(tmp_path / "r.gwtc"),
                                              rel_eb=1e-3, tile=(8, 8, 8), shape=field.shape)):
        with pytest.raises(ValueError, match="abs_eb"):
            run()
    with pytest.raises(ValueError, match="exactly one"):
        stream_compress(field, str(tmp_path / "p.gwtc"), device=CPU)


def test_eb_overflow_guard(tmp_path, field):
    for run in (lambda: api.compress_stream(field * 1e7, tmp_path / "p.gwtc", abs_eb=1e-9,
                                            tile=(8, 8, 8), mem_budget=1 << 20, device=CPU),
                lambda: rapi.compress_stream(field * 1e7, tmp_path / "r.gwtc", abs_eb=1e-9,
                                             tile=(8, 8, 8), mem_budget=1 << 20)):
        with pytest.raises(ValueError, match="too small for data magnitude"):
            run()
    with pytest.raises(ValueError, match="too small for data magnitude"):
        stream_compress(field * 1e7, str(tmp_path / "q.gwtc"), rel_eb=1e-12, tile=(8, 8, 8),
                        device=CPU)


def test_stream_into_an_open_writer(tmp_path, field, ref_lorenzo):
    """A pre-made writer must agree with the encode settings; one that does
    receives the reference's bytes."""
    out = tmp_path / "w.gwtc"
    with open(out, "wb") as f:
        w = GWTCWriter(f, shape=field.shape, tile=TILE, eb_abs=1e-3, predictor="lorenzo")
        rep = stream_compress(field, w, device=CPU, **LOR)
    assert rep.path is None and out.read_bytes() == ref_lorenzo[1]
    bad = GWTCWriter(tmp_path / "b.gwtc", shape=field.shape, tile=TILE, eb_abs=2e-3)
    with pytest.raises(ValueError, match="does not match the encode settings"):
        stream_compress(field, bad, device=CPU, **LOR)
    bad.abort()


def test_compress_stream_without_device_needs_cuda(tmp_path, field):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.compress_stream(field, tmp_path / "x.gwtc", abs_eb=1e-3)
    assert not os.path.exists(tmp_path / "x.gwtc")
    np.save(tmp_path / "x.npy", field)
    with pytest.raises(SystemExit) as e:  # --device cuda is the CLI's default
        cli.main(["compress", str(tmp_path / "x.npy"), str(tmp_path / "x.gwtc"), "--eb",
                  "1e-3", "--stream"])
    assert e.value.code == 2 and not os.path.exists(tmp_path / "x.gwtc")
