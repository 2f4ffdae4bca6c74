"""Port parity: the ``repro_torch.api`` façade and the ``repro_torch.cli``
shell front door, against ``repro.api`` and ``repro.cli``, on the CPU.

Everything here is bit-exact: the handles hold Lorenzo SZJX and GWTC
artifacts without an enhancer, whose decodes are integer paths, and the
two CLIs must write byte-identical files.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import api as rapi
from repro import cli as rcli
from repro_torch import api, cli
from repro_torch.data import nyx_like_field
from repro_torch.errors import CorruptLaneError

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
SHAPE = (20, 24, 28)


@pytest.fixture(scope="module")
def field():
    return nyx_like_field(SHAPE, "temperature", seed=4)


@pytest.fixture(scope="module")
def volumes(field):
    """container -> (port handle, reference handle over the same bytes)."""
    out = {}
    for name, tiled in (("szjx", False), ("gwtc", True)):
        vol = api.compress(field, eb=1e-3, predictor="lorenzo", tiled=tiled, tile=(8, 8, 8),
                           device=CPU)
        out[name] = (vol, rapi.from_bytes(vol.to_bytes()))
    return out


KEYS = {
    "int": (3,),
    "negative_int": (-1, 2),
    "ints_everywhere": (4, -3, 27),
    "steps": (slice(1, 19, 3), slice(None, None, 5), slice(2, 27, 2)),
    "ellipsis_first": (Ellipsis, 7),
    "ellipsis_middle": (slice(2, 9), Ellipsis, slice(10, 20)),
    "missing_axes": (slice(5, 12),),
    "full": (slice(None),) * 3,
    "empty_range": (slice(5, 5), slice(None), 3),
    "empty_stop_before_start": (slice(9, 2), 0),
    "clipped_stop": (slice(15, 99), slice(-5, None)),
    "numpy_int": (np.int64(2), slice(None), np.int32(-2)),
}
BAD_KEYS = {
    "too_many": (1, 2, 3, 4),
    "out_of_bounds": (20,),
    "negative_out_of_bounds": (0, -25),
    "negative_step": (slice(None, None, -1),),
    "two_ellipses": (Ellipsis, 1, Ellipsis),
    "float": (1.5,),
}


@pytest.mark.parametrize("container", ["szjx", "gwtc"])
@pytest.mark.parametrize("key", list(KEYS), ids=list(KEYS))
def test_slicing_matches_full_decode_and_reference(volumes, container, key):
    vol, rvol = volumes[container]
    k = KEYS[key]
    got = vol[k]
    full = np.asarray(vol)
    want = np.asarray(full[k])
    assert np.shape(got) == want.shape
    np.testing.assert_array_equal(np.asarray(got).view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(np.asarray(got).view(np.uint32),
                                  np.asarray(rvol[k]).view(np.uint32))
    if isinstance(got, np.ndarray) and got.size:
        got[...] = 0  # slices are fresh arrays: the cache must not change
        assert np.array_equal(np.asarray(vol)[k], want)


@pytest.mark.parametrize("container", ["szjx", "gwtc"])
@pytest.mark.parametrize("key", list(BAD_KEYS), ids=list(BAD_KEYS))
def test_bad_keys_raise_index_error(volumes, container, key):
    vol, rvol = volumes[container]
    with pytest.raises(IndexError):
        vol[BAD_KEYS[key]]
    with pytest.raises(IndexError):
        rvol[BAD_KEYS[key]]


@pytest.mark.parametrize("container", ["szjx", "gwtc"])
def test_region_lane_count_and_stats_match_reference(volumes, container):
    vol, rvol = volumes[container]
    for roi in [(slice(0, 8), slice(8, 16), slice(0, 8)), (3, Ellipsis),
                (slice(4, 4),), (slice(None),)]:
        assert api.region_lane_count(vol, roi) == rapi.region_lane_count(rvol, roi)
    assert vol.stats.tiles_total == rvol.stats.tiles_total
    assert (vol.shape, vol.nbytes, vol.tiled, vol.enhanced) == (
        rvol.shape, rvol.nbytes, rvol.tiled, rvol.enhanced)
    assert vol.size_report() == rvol.size_report()


def test_region_reads_go_through_the_tile_cache(field):
    vol = api.compress(field, eb=1e-3, predictor="lorenzo", tiled=True, tile=(8, 8, 8),
                       device=CPU)
    roi = (slice(0, 8), slice(8, 16), slice(0, 12))  # 2 lanes
    a = vol[roi]
    assert (vol.stats.tiles_decoded, vol.stats.cache_hits) == (2, 0)
    b = vol[roi]
    assert (vol.stats.tiles_decoded, vol.stats.cache_hits) == (2, 2)
    assert np.array_equal(a, b)
    assert vol._cache is None  # a region read never fills the full-decode cache


@pytest.mark.parametrize("mmap", [True, False])
@pytest.mark.parametrize("container", ["szjx", "gwtc"])
def test_save_open_round_trip(volumes, tmp_path, container, mmap):
    vol, _ = volumes[container]
    path = tmp_path / f"v.{container}"
    n = api.save(path, vol)
    assert n == vol.nbytes == path.stat().st_size
    with api.open(path, mmap=mmap, device=CPU) as back:
        assert back.to_bytes() == vol.to_bytes()
        np.testing.assert_array_equal(np.asarray(back), np.asarray(vol))
        np.testing.assert_array_equal(back[2:9, ..., 3], np.asarray(vol)[2:9, ..., 3])
        assert back.tiled == (container == "gwtc")
    with pytest.raises(ValueError, match="closed"):
        back[0]
    # the reference opens the port's file
    with rapi.open(path) as rvol:
        np.testing.assert_array_equal(np.asarray(rvol), np.asarray(vol))


def _flip_a_lane(vol, path, lane=3):
    from repro_torch.sz import tiled

    blob = bytearray(vol.to_bytes())
    blob[tiled.lane_offset(vol.artifact, lane) + 5] ^= 0x10
    path.write_bytes(bytes(blob))
    return lane


def test_verify_full_raises_on_a_flipped_lane(volumes, tmp_path):
    vol, _ = volumes["gwtc"]
    path = tmp_path / "bad.gwtc"
    lane = _flip_a_lane(vol, path)
    with pytest.raises(CorruptLaneError) as e:
        api.open(path, verify="full", device=CPU)
    assert e.value.tile_id == lane
    with pytest.raises(CorruptLaneError):  # lazy: raises on the first decode
        np.asarray(api.open(path, device=CPU))
    assert api.open(path, verify="none", device=CPU).artifact.quarantined == set()


def test_quarantine_fills_the_tile_and_counts_it(volumes, tmp_path):
    vol, _ = volumes["gwtc"]
    path = tmp_path / "bad.gwtc"
    lane = _flip_a_lane(vol, path)
    with api.open(path, verify="full", on_corrupt="quarantine", fill_value=-3.0,
                  device=CPU) as bad:
        assert bad.artifact.quarantined == {lane}
        full = np.asarray(bad)
        assert bad.stats.quarantined == 1
        good = np.asarray(vol)
        tile = bad.artifact.tile
        g = np.unravel_index(lane, bad.artifact.grid)
        sl = tuple(slice(i * t, (i + 1) * t) for i, t in zip(g, tile))
        assert (full[sl] == -3.0).all()
        mask = np.ones(full.shape, bool)
        mask[sl] = False
        np.testing.assert_array_equal(full[mask], good[mask])
        np.testing.assert_array_equal(bad[sl], full[sl])


def test_enhanced_mono_handle(field):
    from repro_torch.core.trainer import GWLZTrainConfig

    cfg = GWLZTrainConfig(n_groups=2, epochs=1, min_group_pixels=64)
    vol = api.compress(field, eb=1e-3, predictor="lorenzo", enhance=cfg, device=CPU)
    assert vol.enhanced and not vol.tiled
    assert vol.stats.psnr_gwlz >= vol.stats.psnr_sz - 1e-3  # forwarded GWLZStats
    back = api.from_bytes(vol.to_bytes(), device=CPU)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(vol))
    np.testing.assert_array_equal(back[1:7, 3], np.asarray(back)[1:7, 3])


def test_entry_points_without_device_need_cuda(volumes, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    vol, _ = volumes["szjx"]
    path = tmp_path / "v.szjx"
    api.save(path, vol)
    for call in (lambda: api.compress(np.ones((4, 4, 4), np.float32), eb=1e-3,
                                      predictor="lorenzo"),
                 lambda: api.open(path), lambda: api.from_bytes(vol.to_bytes()),
                 lambda: api.CompressedVolume(vol.artifact)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_parts_not_ported_raise(volumes, tmp_path):
    with pytest.raises(NotImplementedError, match="item 7"):
        api.compress_stream("x.npy", tmp_path / "x.gwtc", abs_eb=1.0)
    with pytest.raises(NotImplementedError, match="item 9"):
        api.save(tmp_path / "d.gwds", {"t": volumes["szjx"][0]})
    with pytest.raises(NotImplementedError, match="item 9"):
        api.from_bytes(b"GWDS" + bytes(12), device=CPU)


# ---------------------------------------------------------------------------
# CLI: the CI smoke replayed on both front doors (.github/workflows/ci.yml)
# ---------------------------------------------------------------------------


def _run(main, argv) -> int:
    try:
        return main(argv)
    except SystemExit as e:
        return e.code


@pytest.mark.parametrize("mode", ["tiled", "mono"])
def test_cli_replay_is_byte_identical(tmp_path, mode, capsys):
    flags = ["--tiled", "--tile", "8"] if mode == "tiled" else []
    for pkg, main, pre in (("ref", rcli.main, []), ("port", cli.main, ["--device", CPU])):
        d = tmp_path / pkg
        d.mkdir()
        f = str(d / "field.gw")
        assert _run(main, pre + ["compress", "synthetic:temperature:24", f, "--eb", "1e-3",
                                 *flags, "--predictor", "lorenzo"]) == 0
        assert _run(main, pre + ["info", f]) == 0
        assert _run(main, pre + ["region", f, "--roi", "0:8,8:16,0:8",
                                 "--out", str(d / "roi.npy")]) == 0
        assert _run(main, pre + ["decompress", f, str(d / "full.npy")]) == 0
        assert _run(main, pre + ["verify", f]) == 0
        full, roi = np.load(d / "full.npy"), np.load(d / "roi.npy")
        assert np.array_equal(roi, full[0:8, 8:16, 0:8])
    for name in ("field.gw", "full.npy", "roi.npy"):
        assert (tmp_path / "ref" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()


def test_cli_exit_codes_match_reference(tmp_path, capsys):
    src = tmp_path / "x.npy"
    np.save(src, nyx_like_field((16, 16, 16), "temperature", seed=2))
    good = tmp_path / "good.gwtc"
    assert _run(cli.main, ["--device", CPU, "compress", str(src), str(good), "--abs-eb", "10",
                           "--tiled", "--tile", "8", "--predictor", "lorenzo"]) == 0
    bad = tmp_path / "bad.gwtc"
    blob = bytearray(good.read_bytes())
    blob[60] ^= 0xFF  # inside the first lane
    bad.write_bytes(bytes(blob))
    cases = [
        (["verify", str(bad)], 1),
        (["decompress", str(bad), str(tmp_path / "o.npy")], 1),
        (["region", str(bad), "--roi", "0:8,0:8,0:8"], 1),
        (["verify", str(tmp_path / "missing.gwtc")], 2),
        (["region", str(good), "--roi", "0:8,0:99:-1"], 2),
        (["region", str(good), "--roi", "0:8,,0:8"], 2),
        (["region", str(good), "--roi", "99"], 2),
        (["compress", str(src), str(tmp_path / "o.gwtc")], 2),  # no --eb
        (["compress", str(tmp_path / "missing.npy"), str(tmp_path / "o.gwtc"),
          "--eb", "1e-3", "--predictor", "lorenzo"], 2),
    ]
    for argv, code in cases:
        assert _run(rcli.main, argv) == code, argv
        assert _run(cli.main, ["--device", CPU] + argv) == code, argv
    # the port's own usage errors: parts not ported yet
    for argv in (["compress", str(src), str(tmp_path / "s.gwtc"), "--eb", "1e-3",
                  "--predictor", "lorenzo", "--stream"],
                 ["compress", str(src), str(tmp_path / "i.szjx"), "--eb", "1e-3"]):
        assert _run(cli.main, ["--device", CPU] + argv) == 2
    assert "item" in capsys.readouterr().err


def test_cli_runs_as_a_module(tmp_path):
    """``python -m repro_torch.cli``: without a card the default device is a
    usage error."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tmp_path / "m.szjx"
    cmd = ["compress", "synthetic:temperature:12", str(out), "--eb", "1e-3", "--predictor",
           "lorenzo"]
    base = [sys.executable, "-m", "repro_torch.cli"]
    if not torch.cuda.is_available():
        r = subprocess.run(base + cmd, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 2 and "--device cpu" in r.stderr
    r = subprocess.run(base + ["--device", CPU] + cmd, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert out.stat().st_size > 0
