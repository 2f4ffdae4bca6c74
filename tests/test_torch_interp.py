"""Port parity: the interp predictor (SZ3-style multi-level interpolation),
monolithic (SZJX) and tiled (GWTC), linear and cubic.

The port's interp arithmetic is its own (``repro_torch/sz/predictor.py``):
single float32 operations, no fused multiply-add.  The reference's float
results follow XLA's fusion, so the two packages agree on integers and
headers exactly and on floats within a stated tolerance:

* ``TOL = 8 eps max|x|`` with eps = 2**-23 (float32 ulps of the values, not
  fractions of eb: at rel_eb 1e-5, eps max|x| is ~1e-2 eb);
* the port's decode of a reference payload is within ``TOL`` of the
  reference's decode;
* either package decodes the other's artifacts within ``eb + TOL`` of the
  source;
* the codes equal the reference's on at least 99.9% of positions.  A code
  that differs changes the reconstruction the predictions after it read,
  so the share grows as fields shrink (velocity_x at rel_eb 1e-4 falls
  below 99.9% at 33 x 40 x 29, so the case runs at 65^3);
* shape, padded shape, levels, order and eb bits are identical.

``interp_fma_probe.py`` measures the first three on four fields (at most
1.35 eps max|x|, eb + 0.47 eps max|x|, and 31 of 274,625 codes, all on
velocity_x 65^3 at rel_eb 1e-4).

The port's own artifacts hold ``max|x - x'| <= float32(eb)`` exactly, and a
region decode equals the full decode's crop bit for bit.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.sz import predictor as RP
from repro.sz import quantizer as RQ
from repro.sz import szjax as RS
from repro.sz import tiled as RT
from repro_torch import api
from repro_torch.data import nyx_like_field
from repro_torch.errors import CorruptContainerError
from repro_torch.sz import predictor as P
from repro_torch.sz import quantizer as Q
from repro_torch.sz import szjax as PS
from repro_torch.sz import tiled as PT

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CPU = "cpu"
EPS = 2.0**-23
CODE_MATCH = 0.999


def _tol(x) -> float:
    return 8 * EPS * float(np.abs(x).max())


def _err(a, x) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(x, np.float64)).max())


def _bound(eb: float) -> float:
    return float(np.float32(eb))


def _volume(case: str) -> np.ndarray:
    """The shared inputs (few shapes, so the reference compiles few
    programs)."""
    if case == "temperature":
        return nyx_like_field((33, 40, 29), "temperature", seed=3)
    if case == "velocity_x_65":
        return nyx_like_field((65, 65, 65), "velocity_x", seed=0)
    if case == "plane":
        return np.cumsum(np.random.default_rng(1).normal(0, 5, (100, 100)),
                         axis=1).astype(np.float32)
    if case == "line":
        return np.cumsum(np.random.default_rng(2).normal(0, 5, (300,))).astype(np.float32)
    if case == "spikes":  # residuals of ~1e6 / 2eb: codes past the outlier radius
        x = nyx_like_field((20, 17, 23), "temperature", seed=5)
        x.reshape(-1)[np.random.default_rng(5).choice(x.size, 40, replace=False)] = 1e7
        return x
    raise KeyError(case)


# ---------------------------------------------------------------------------
# the residual quantizer
# ---------------------------------------------------------------------------


def test_quantize_residual_matches_reference_on_ties_and_the_radius():
    """.5 ties of (x - pred) / 2eb round half to even; |code| = 2**15 - 1
    is a code, 2**15 an outlier (stored exactly, code 0).  Every value here
    is exact in float32, so the two packages must agree bit for bit."""
    R = Q.OUTLIER_RADIUS
    assert R == RQ.OUTLIER_RADIUS == 2**15
    d = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, R - 1, R - 1.5, R - 0.5, R, -R + 1,
                  -R + 0.5, -R, R + 7, 3.25, -7.75], np.float32)
    pred = np.linspace(-4, 4, d.size).astype(np.float32)
    x = pred + d  # exact: eb 0.5, so 2eb = 1 and the codes are rint(d)
    code, rec, out = Q.quantize_residual(torch.from_numpy(x), torch.from_numpy(pred), 0.5)
    rcode, rrec, rout = RQ.quantize_residual(jnp.asarray(x), jnp.asarray(pred), 0.5)
    np.testing.assert_array_equal(code.numpy(), np.asarray(rcode))
    np.testing.assert_array_equal(out.numpy(), np.asarray(rout))
    np.testing.assert_array_equal(rec.numpy().view(np.uint32), np.asarray(rrec).view(np.uint32))
    assert code.numpy().tolist()[:6] == [0, 2, 2, 0, -2, -2]
    assert out.numpy().tolist()[6:14] == [False, False, True, True, False, True, True, True]


# ---------------------------------------------------------------------------
# the port's own artifacts: the bound, exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", ["cubic", "linear"])
@pytest.mark.parametrize("case,tile", [("line", 64), ("plane", (16, 32)),
                                       ("temperature", (16, 16, 8)), ("spikes", 8)])
def test_port_artifacts_hold_the_bound(case, tile, order):
    x = _volume(case)
    abs_eb = 1.0 if case == "spikes" else None
    rel_eb = None if abs_eb else 1e-3
    sz = PS.SZCompressor(order=order)
    art, rec = sz.compress(x, rel_eb=rel_eb, abs_eb=abs_eb, device=CPU)
    back = PS.decompress(PS.SZCompressed.from_bytes(art.to_bytes()), device=CPU)
    assert torch.equal(back, rec) and back.shape == x.shape
    assert _err(back, x) <= _bound(art.eb_abs)
    tart, trec = sz.compress_tiled(x, tile, rel_eb=rel_eb, abs_eb=abs_eb, device=CPU)
    tback = PT.decompress_tiled(PT.TiledCompressed.from_bytes(tart.to_bytes()), device=CPU)
    assert torch.equal(tback, trec) and tback.shape == x.shape
    assert _err(tback, x) <= _bound(tart.eb_abs)
    if case == "spikes":  # every spike off the coarse grid is an outlier
        assert art.outlier_idx.size >= 30
        assert sum(_lane_outliers(b) for b in tart.tile_blobs) >= 30


def _lane_outliers(blob: bytes) -> int:
    return P._INTERP_LANE_HDR.unpack_from(blob, 0)[0]


def test_straggler_promotion_repairs_a_drifting_decoder(monkeypatch):
    """The port's decoder repeats its encoder's arithmetic, so no point is
    promoted in practice; a decoder that drifts by 3 eb on some points off
    the coarse grid (which is integer-exact) forces rounds, and the promoted
    artifact holds the bound under it."""
    x = _volume("temperature")
    eb = 1e-3 * float(x.max() - x.min())
    levels = P._num_levels(x.shape)
    xp = P.pad_edge(torch.from_numpy(x), P._padded_shape(x.shape, levels))[None]
    codes, omask, ovals, recon, rounds = P.interp_encode_batch(xp, eb, levels, "cubic")
    assert rounds == 0
    plain = P._interp_decode_padded
    coarse = torch.zeros(xp.shape, dtype=torch.bool)
    coarse[P._coarse(3, levels)] = True
    drift = torch.zeros(xp.shape, dtype=torch.bool)
    drift.view(-1)[::37] = True
    drift &= ~coarse

    def drifting(c, m, v, eb_, lv, order):
        r = plain(c, m, v, eb_, lv, order)
        return torch.where(drift & ~m, r + 3 * eb_, r)

    monkeypatch.setattr(P, "_interp_decode_padded", drifting)
    codes, omask, ovals, recon, rounds = P.interp_encode_batch(xp, eb, levels, "cubic")
    assert rounds >= 1
    assert torch.equal(recon, drifting(codes, omask, ovals, eb, levels, "cubic"))
    assert bool(omask[drift].all())
    assert float((recon - xp).abs().max()) <= _bound(eb)


# ---------------------------------------------------------------------------
# random access: region == full crop, bit for bit
# ---------------------------------------------------------------------------

REGION_X = nyx_like_field((56, 16, 16), "temperature", seed=9)  # 7 x 2 x 2 tiles of 8^3
REGION_ROIS = {1: ((9, 15), (1, 7), (10, 12)), 3: ((0, 24), (0, 8), (0, 8)),
               7: ((3, 53), (9, 16), (8, 9))}


@pytest.fixture(scope="module")
def region_art():
    art, recon = PT.compress_tiled(REGION_X, 8, rel_eb=1e-3, predictor="interp", device=CPU)
    back = PT.TiledCompressed.from_bytes(art.to_bytes())
    return back, PT.decompress_tiled(back, device=CPU), recon


@pytest.mark.parametrize("n", [1, 3, 7])
def test_region_equals_full_crop(region_art, n):
    art, full, recon = region_art
    assert torch.equal(full, recon)
    roi = REGION_ROIS[n]
    ids, _ = PT.region_tiles(art, roi)
    assert ids.size == n
    region = PT.decompress_region(art, roi, device=CPU)
    assert torch.equal(region, full[tuple(slice(a, b) for a, b in roi)])
    lanes = np.random.default_rng(n).choice(art.n_tiles, n, replace=False).tolist()
    tiles, _ = PT.decode_lanes(art, lanes, device=CPU)
    whole, _ = PT.decode_lanes(art, range(art.n_tiles), device=CPU)
    assert torch.equal(tiles, whole[lanes])


def test_region_through_the_facade(tmp_path):
    vol = api.compress(REGION_X, eb=1e-3, tiled=True, tile=(8, 8, 8), device=CPU)
    assert vol.artifact.predictor == "interp"
    path = tmp_path / "r.gwtc"
    api.save(path, vol)
    with api.open(path, device=CPU) as back:
        full = np.asarray(back)
        assert np.array_equal(back[3:53, 9:16, 8], full[3:53, 9:16, 8])
    assert _err(full, REGION_X) <= _bound(vol.eb_abs)


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

MONO_CASES = [("temperature", 1e-3, "cubic"), ("velocity_x_65", 1e-4, "cubic"),
              ("plane", 1e-3, "cubic"), ("plane", 1e-3, "linear"), ("line", 1e-3, "cubic")]


@pytest.mark.parametrize("case,rel_eb,order", MONO_CASES)
def test_monolithic_parity_with_reference(case, rel_eb, order):
    x = _volume(case)
    tol = _tol(x)
    art, _ = PS.SZCompressor(order=order).compress(x, rel_eb=rel_eb, device=CPU)
    rart, _ = RS.SZCompressor(order=order).compress(jnp.asarray(x), rel_eb=rel_eb)
    head = lambda a: (tuple(a.shape), tuple(a.padded_shape), a.levels, a.order,
                      np.float64(a.eb_abs).view(np.uint64))
    assert head(art) == head(rart)
    eb = art.eb_abs
    # codes on the padded grid, position by position
    codes = P.interp_encode(torch.from_numpy(x), eb, order)[0].numpy()
    rcodes = np.asarray(RP.interp_encode(jnp.asarray(x), eb, order)[0])
    assert (codes == rcodes).mean() >= CODE_MATCH
    pblob, rblob = art.to_bytes(), rart.to_bytes()
    port_of_ref = PS.decompress(PS.SZCompressed.from_bytes(rblob), device=CPU).numpy()
    ref_of_ref = np.asarray(RS.decompress(RS.SZCompressed.from_bytes(rblob)))
    ref_of_port = np.asarray(RS.decompress(RS.SZCompressed.from_bytes(pblob)))
    assert _err(port_of_ref, ref_of_ref) <= tol
    assert _err(port_of_ref, x) <= eb + tol
    assert _err(ref_of_port, x) <= eb + tol


def test_tiled_parity_with_reference():
    x = nyx_like_field((24, 20, 17), "temperature", seed=6)
    tol = _tol(x)
    art, _ = PT.compress_tiled(x, 8, rel_eb=1e-3, predictor="interp", device=CPU)
    rart, _ = RT.compress_tiled(jnp.asarray(x), (8, 8, 8), rel_eb=1e-3, predictor="interp")
    assert (art.levels, art.eb_abs, art.n_tiles) == (rart.levels, rart.eb_abs, rart.n_tiles)
    pblob, rblob = art.to_bytes(), rart.to_bytes()
    assert pblob[:PT._HDR_V3.size + 48] == rblob[:PT._HDR_V3.size + 48]  # header, shape, tile
    codes = [P.get_predictor("interp").parse_lane(b, tile=art.tile, levels=art.levels,
                                                  device=CPU)["codes"].numpy()
             for b in art.tile_blobs]
    rcodes = [RP.get_predictor("interp").parse_lane(b, tile=rart.tile, levels=rart.levels)["codes"]
              for b in rart.tile_blobs]
    assert np.mean([np.mean(a == b) for a, b in zip(codes, rcodes)]) >= CODE_MATCH
    port_of_ref = PT.decompress_tiled(PT.TiledCompressed.from_bytes(rblob), device=CPU).numpy()
    ref_of_ref = np.asarray(RT.decompress_tiled(RT.TiledCompressed.from_bytes(rblob)))
    ref_of_port = np.asarray(RT.decompress_tiled(RT.TiledCompressed.from_bytes(pblob)))
    assert _err(port_of_ref, ref_of_ref) <= tol
    assert _err(port_of_ref, x) <= art.eb_abs + tol
    assert _err(ref_of_port, x) <= art.eb_abs + tol


@pytest.mark.parametrize("name", ["gwtc_v2", "szjx_interp"])
def test_golden_interp_containers_decode_within_tolerance(name):
    """The golden's own decode may differ from today's reference by a few
    ulps, so the port is held to the source field and to the live
    reference decode."""
    x = np.load(os.path.join(GOLDEN, "volume_12_20_9.npy"))
    with open(os.path.join(GOLDEN, f"{name}.bin"), "rb") as f:
        blob = f.read()
    if name == "gwtc_v2":
        art = PT.TiledCompressed.from_bytes(blob)
        got = PT.decompress_tiled(art, device=CPU).numpy()
        want = np.asarray(RT.decompress_tiled(RT.TiledCompressed.from_bytes(blob)))
    else:
        art = PS.SZCompressed.from_bytes(blob)
        got = PS.decompress(art, device=CPU).numpy()
        want = np.asarray(RS.decompress(RS.SZCompressed.from_bytes(blob)))
    assert art.predictor == "interp" and got.shape == x.shape == (12, 20, 9)
    assert _err(got, want) <= _tol(x)
    assert _err(got, x) <= art.eb_abs + _tol(x)


def test_lane_layout_parses_in_both_packages():
    """Lanes the port writes parse in the reference to the same codes,
    outlier mask and values, and the other way round; the batched lane
    writer gives the one-lane writer's bytes."""
    x = PT.split_tiles(torch.from_numpy(_volume("spikes")[:16, :16, :16].copy()), (8, 8, 8))
    pred, rpred = P.get_predictor("interp"), RP.get_predictor("interp")
    levels = pred.plan((8, 8, 8))
    payload, _ = pred.encode_tiles(x, 1.0, order="cubic", levels=levels)
    lanes = pred.lane_bytes_batch(payload, 8, "huffman+zlib")
    assert lanes == [pred.lane_bytes(payload, i, "huffman+zlib") for i in range(8)]
    assert sum(_lane_outliers(b) for b in lanes) > 0
    for i, lane in enumerate(lanes):
        got = rpred.parse_lane(lane, tile=(8, 8, 8), levels=levels)
        for k in ("codes", "omask", "ovals"):
            np.testing.assert_array_equal(got[k], payload[k][i].numpy())
    rpayload = {k: np.asarray(v) for k, v in payload.items()}
    for i in range(8):
        blob = rpred.lane_bytes(rpayload, i, "zlib")
        got = pred.parse_lane(blob, tile=(8, 8, 8), levels=levels, device=CPU)
        for k in ("codes", "omask", "ovals"):
            assert torch.equal(got[k], payload[k][i])


def test_outlier_index_outside_the_volume_raises():
    art, _ = PS.SZCompressor().compress(_volume("spikes"), abs_eb=1.0, device=CPU)
    assert art.outlier_idx.size
    art.outlier_idx[-1] = int(np.prod(art.padded_shape))
    with pytest.raises(CorruptContainerError, match="outlier index"):
        PS.decompress(art, device=CPU)


def test_tiled_gwlz_on_the_default_predictor(tmp_path):
    """GWLZ over interp tiles trains on the decoder's own (padded-grid)
    tiles: the enhanced decode reproduces the compress-time PSNR and a
    region read equals the full decode's crop."""
    from repro_torch.core import metrics
    from repro_torch.core.trainer import GWLZTrainConfig

    vol = api.compress(REGION_X, eb=1e-3, tiled=True, tile=(8, 8, 8),
                       enhance=GWLZTrainConfig(n_groups=4, epochs=2), device=CPU)
    stats = vol.stats
    assert vol.artifact.predictor == "interp" and "gwlz" in vol.artifact.extras
    assert stats.psnr_gwlz >= stats.psnr_sz - 1e-3
    api.save(tmp_path / "g.gwtc", vol)
    with api.open(tmp_path / "g.gwtc", device=CPU) as back:
        full = np.asarray(back)
        assert np.array_equal(back[3:53, 9:16, 8], full[3:53, 9:16, 8])
    psnr = float(metrics.psnr(torch.from_numpy(REGION_X), torch.tensor(full)))
    assert psnr == stats.psnr_gwlz
