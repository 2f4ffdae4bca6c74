"""Port parity: tiled GWLZ end to end (compress with enhancer training,
enhanced full and region decode) on a 32^3 field, tile 16^3, G = 4,
3 epochs, Lorenzo.

* The model blob is byte-identical across packages in both directions.
* Each package decodes the other's artifact, enhanced, to within
  1e-5 eb + 1 spacing(x) per value of the other's own decode: group ids
  are integer-exact and the decoded SZ data is bit-exact, so the two
  differ only in the enhancer's float sums (~1e-6 of the prediction,
  times rscale ~ eb), after which x + rhat may round to the next float.
* In the port, region decode equals the full decode's crop bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import pipeline as RP
from repro.sz import tiled as RT
from repro.sz.szjax import SZCompressor
from repro_torch.core import pipeline as PP
from repro_torch.data import nyx_like_field
from repro_torch.sz import szjax as PSZ
from repro_torch.sz import tiled as PT

TILE, REL_EB = (16, 16, 16), 1e-3
CFG = dict(n_groups=4, epochs=3)
ROI = [(3, 20), (0, 17), (5, 32)]


@pytest.fixture(scope="module")
def field():
    return nyx_like_field((32, 32, 32), "temperature", seed=7)


@pytest.fixture(scope="module")
def ref_run(field):
    gw = RP.GWLZ(sz=SZCompressor(predictor="lorenzo"), train_cfg=RP.GWLZTrainConfig(**CFG))
    art, stats = gw.compress_tiled(jnp.asarray(field), TILE, rel_eb=REL_EB)
    return gw, art.to_bytes(), stats


@pytest.fixture(scope="module")
def port_run(field):
    gw = PP.GWLZ(sz=PSZ.SZCompressor(predictor="lorenzo"), train_cfg=PP.GWLZTrainConfig(**CFG))
    art, stats = gw.compress_tiled(field, TILE, rel_eb=REL_EB, device="cpu")
    return gw, art.to_bytes(), stats


def _within(got, want, eb, x):
    got, want, x = (np.asarray(a, np.float32) for a in (got, want, x))
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 1e-5 * eb + np.spacing(np.abs(x))).all()


def test_model_blob_is_byte_identical_both_ways(ref_run, port_run):
    for blob in (PT.TiledCompressed.from_bytes(port_run[1]).extras["gwlz"],
                 RT.TiledCompressed.from_bytes(ref_run[1]).extras["gwlz"]):
        assert RP.serialize_model(RP.deserialize_model(blob)) == blob
        assert PP.serialize_model(PP.deserialize_model(blob, device="cpu")) == blob


def test_sz_half_is_byte_identical(ref_run, port_run):
    """Everything but the model blob: header, lanes, index."""
    rart = RT.TiledCompressed.from_bytes(ref_run[1])
    part = PT.TiledCompressed.from_bytes(port_run[1])
    assert [bytes(b) for b in rart.tile_blobs] == [bytes(b) for b in part.tile_blobs]
    assert ref_run[2].psnr_sz == pytest.approx(port_run[2].psnr_sz, abs=1e-3)
    assert ref_run[2].overhead == port_run[2].overhead


def test_each_package_decodes_the_others_artifact(field, ref_run, port_run):
    rgw, rblob, rstats = ref_run
    pgw, pblob, _ = port_run
    eb = rstats.eb_abs
    rart, part = RT.TiledCompressed.from_bytes(rblob), PT.TiledCompressed.from_bytes(rblob)
    _within(pgw.decompress_tiled(part, device="cpu").numpy(), rgw.decompress_tiled(rart),
            eb, field)
    rart, part = RT.TiledCompressed.from_bytes(pblob), PT.TiledCompressed.from_bytes(pblob)
    _within(rgw.decompress_tiled(rart), pgw.decompress_tiled(part, device="cpu").numpy(),
            eb, field)


def test_port_decode_region_and_stats(field, port_run):
    gw, blob, stats = port_run
    art = PT.TiledCompressed.from_bytes(blob)
    full = gw.decompress_tiled(art, device="cpu")
    assert full.shape == field.shape and bool(torch.isfinite(full).all())
    region = gw.decompress_region(art, ROI, device="cpu")
    assert torch.equal(region, full[tuple(slice(a, b) for a, b in ROI)])
    from repro_torch.core import metrics
    assert float(metrics.psnr(torch.from_numpy(field), full)) == stats.psnr_gwlz
    assert stats.psnr_gwlz >= stats.psnr_sz - 1e-3
    assert stats.n_model_params == 4 * 190
    tiles = gw.decode_tiles(art, [0, 5], device="cpu")
    every = PT.split_tiles(PT.pad_to_tiles(full, art.tile), art.tile)
    assert torch.equal(tiles, every[[0, 5]])


def test_clamped_decode_stays_within_twice_the_bound(field, port_run):
    _, blob, stats = port_run
    art = PT.TiledCompressed.from_bytes(blob)
    out = PP.GWLZ(clamp_to_bound=True).decompress_tiled(art, device="cpu")
    err = float((out.double() - torch.from_numpy(field).double()).abs().max())
    assert err <= 2 * stats.eb_abs * (1 + 1e-5)


def test_quarantined_lane_stays_at_the_fill_value(port_run):
    gw, blob, _ = port_run
    blob = bytearray(blob)
    lane = 3
    off = PT.lane_offset(PT.TiledCompressed.from_bytes(bytes(blob)), lane)
    blob[off + 10] ^= 0x40
    art = PT.TiledCompressed.from_bytes(bytes(blob))
    art.on_corrupt, art.fill_value = "quarantine", -7.0
    tiles = gw.decode_tiles(art, range(art.n_tiles), device="cpu")
    assert bool((tiles[lane] == -7.0).all())
    assert not bool((tiles[lane - 1] == -7.0).any())
    full = gw.decompress_tiled(art, device="cpu")
    assert torch.equal(PT.split_tiles(full, art.tile)[lane], tiles[lane])


def test_entry_points_without_device_need_cuda(field, port_run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    gw, blob, _ = port_run
    art = PT.TiledCompressed.from_bytes(blob)
    with pytest.raises(RuntimeError, match="CUDA"):
        gw.compress_tiled(field, TILE, rel_eb=REL_EB)
    for call in (lambda: gw.decompress_tiled(art), lambda: gw.decompress_region(art, ROI),
                 lambda: PP.deserialize_model(art.extras["gwlz"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_metrics_match_reference(field):
    from repro.core import metrics as RM
    from repro_torch.core import metrics as PM

    y = field + np.random.default_rng(1).normal(0, 50, field.shape).astype(np.float32)
    for name in ("mse", "vrange", "psnr", "nrmse", "max_abs_err"):
        got = float(getattr(PM, name)(torch.from_numpy(field), torch.from_numpy(y))
                    if name != "vrange" else PM.vrange(torch.from_numpy(field)))
        want = float(getattr(RM, name)(field, y) if name != "vrange" else RM.vrange(field))
        assert got == pytest.approx(want, rel=1e-5), name
