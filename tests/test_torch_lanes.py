"""Port parity: the lane-batched entropy fit and pack.

``encode_codes_lanes`` fits and packs many lanes with one histogram launch
and one encode launch; its blobs must equal the port's one-lane
``encode_codes`` and the reference's ``repro.sz.entropy.encode_codes`` byte
for byte.  On CPU tensors the plain versions of the kernels run
(``symbol_hist_lanes_ref``, ``huffman_encode_ref``); the lane histogram's
plain version is also held against the reference's Pallas ``symbol_hist``
in interpret mode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as rops
from repro.sz import entropy as R
from repro.sz import tiled as RT
from repro_torch.kernels import ops, ref
from repro_torch.sz import compress_tiled
from repro_torch.sz import entropy as P
from repro_torch.sz import predictor as PP
from repro_torch.sz import tiled as PT

CPU = torch.device("cpu")
WIDE = P._LANES_SPAN + 1000  # past the batch span cap: the one-lane route


def _lanes(case: str) -> np.ndarray:
    """int32 lanes [L, *tile] with spans that differ between lanes."""
    rng = np.random.default_rng(len(case))
    if case == "spans_differ":
        lanes = np.stack([rng.integers(-s, s + 1, (6, 8, 8)) for s in (0, 1, 3, 40, 700, 3)])
    elif case == "one_symbol_lane":
        lanes = rng.integers(-5, 6, (4, 6, 8, 8))
        lanes[2] = -7
    elif case == "wide_lane":
        lanes = rng.integers(-20, 21, (3, 6, 8, 8))
        lanes[1, 0, 0, :2] = (-20, WIDE - 21)  # span WIDE > the cap
        lanes[2, 1, 1, 1] = 2**30  # and one far past the dense span
    elif case == "tile_5x7x9":  # 315 symbols: a short last chunk per lane
        lanes = np.round(rng.normal(0, 3, (5, 5, 7, 9))).astype(np.int64)
    elif case == "skewed":
        lanes = rng.choice([0] * 20 + [1, -1, 2, -9], size=(7, 4, 16, 16))
    else:
        raise KeyError(case)
    return lanes.astype(np.int32)


CASES = ("spans_differ", "one_symbol_lane", "wide_lane", "tile_5x7x9", "skewed")


@pytest.mark.parametrize("backend", ("huffman", "huffman+zlib"))
@pytest.mark.parametrize("case", CASES)
def test_lanes_equal_one_lane_and_reference_blobs(case, backend):
    lanes = _lanes(case)
    got = P.encode_codes_lanes(torch.from_numpy(lanes), backend)
    assert len(got) == lanes.shape[0]
    for blob, lane in zip(got, lanes):
        assert blob == P.encode_codes(torch.from_numpy(lane), backend)
        assert blob == R.encode_codes(lane, backend, use_pallas=False)
        np.testing.assert_array_equal(
            P.decode_codes(blob, lane.shape, device="cpu").numpy(), lane)


@pytest.mark.parametrize("chunk_size", [1, 31, 255, 257, 1024])
def test_lanes_at_other_chunk_sizes(chunk_size):
    lanes = _lanes("tile_5x7x9")
    got = P.encode_codes_lanes(torch.from_numpy(lanes), "huffman", chunk_size=chunk_size)
    for blob, lane in zip(got, lanes):
        assert blob == R.encode_codes(lane, "huffman", chunk_size=chunk_size, use_pallas=False)


@pytest.mark.parametrize("backend", ("zlib", "huffman"))
def test_lanes_edge_shapes(backend):
    """No lanes, empty lanes and the zlib backend: the one-lane blobs."""
    assert P.encode_codes_lanes(torch.zeros((0, 4), dtype=torch.int32), backend) == []
    empty = np.zeros((3, 0), np.int32)
    assert P.encode_codes_lanes(torch.from_numpy(empty), backend) == [
        R.encode_codes(e, backend, use_pallas=False) for e in empty]
    lanes = _lanes("spans_differ")
    assert P.encode_codes_lanes(torch.from_numpy(lanes), backend) == [
        R.encode_codes(lane, backend, use_pallas=False) for lane in lanes]


def test_lane_spans_dispatch(monkeypatch):
    """Lanes up to the span cap share one histogram call; a wider lane is
    fitted alone (a one-row histogram up to the dense span, torch.unique
    past it)."""
    calls = []
    real = ops.symbol_hist_lanes_op

    def spy(codes, lo, *, n_bins):
        calls.append((codes.shape[0], lo is None, n_bins))
        return real(codes, lo, n_bins=n_bins)

    monkeypatch.setattr(ops, "symbol_hist_lanes_op", spy)
    lanes = _lanes("wide_lane")
    P.encode_codes_lanes(torch.from_numpy(lanes), "huffman")
    # lane 1 alone (span WIDE, after the shift: lo None); lane 2 is past the
    # dense span (torch.unique, no histogram); lane 0 in the batched call
    assert calls == [(1, True, WIDE), (1, False, 41)]


@pytest.mark.parametrize("n_bins", [1, 64, 5000])
def test_lane_hist_plain_matches_rows_and_pallas(n_bins):
    rng = np.random.default_rng(n_bins)
    codes = rng.integers(-40, n_bins + 40, (5, 1000)).astype(np.int32)
    codes[3] = 2**31 - 1  # far above every base
    codes[4, :7] = -(2**31)  # far below: an int32 difference would wrap
    lo = np.array([0, -30, 7, -(2**31), 2**31 - 5], np.int32)
    got = ref.symbol_hist_lanes_ref(torch.from_numpy(codes), torch.from_numpy(lo), n_bins)
    assert got.shape == (5, n_bins) and got.dtype == torch.int32
    for row, base, h in zip(codes, lo, got):
        exact = row.astype(np.int64) - int(base)
        want = np.bincount(exact[(exact >= 0) & (exact < n_bins)], minlength=n_bins)
        np.testing.assert_array_equal(h.numpy(), want)
    for row in codes[:3]:  # lo = 0: the one-row plain version and the Pallas kernel
        one = ref.symbol_hist_ref(torch.from_numpy(row), n_bins)
        np.testing.assert_array_equal(
            ref.symbol_hist_lanes_ref(torch.from_numpy(row[None]), None, n_bins)[0], one)
        pallas = rops.symbol_hist_op(jnp.asarray(row), n_bins=n_bins, use_pallas=True,
                                     interpret=True)
        np.testing.assert_array_equal(one.numpy(), np.asarray(pallas))


def test_lane_hist_op_follows_the_device():
    codes = torch.from_numpy(_lanes("skewed").reshape(7, -1))
    lo = torch.aminmax(codes, dim=1)[0]
    got = ops.symbol_hist_lanes_op(codes, lo, n_bins=12)
    assert torch.equal(got, ref.symbol_hist_lanes_ref(codes, lo, 12))
    assert torch.equal(ops.symbol_hist_op(codes[0], n_bins=12),
                       ref.symbol_hist_ref(codes[0], 12))


def test_lorenzo_lane_bytes_batch_is_the_loop():
    lanes = torch.from_numpy(_lanes("spans_differ"))
    pred = PP.get_predictor("lorenzo")
    payload = {"codes": lanes}
    want = [pred.lane_bytes(payload, i, "huffman+zlib") for i in range(4)]
    assert pred.lane_bytes_batch(payload, 4, "huffman+zlib") == want
    assert PP.TilePredictor.lane_bytes_batch(pred, payload, 4, "huffman+zlib") == want


@pytest.mark.parametrize("tile", [(5, 7, 9), (8, 8, 8)])
def test_tiled_bytes_with_a_wide_lane_match_reference(tile):
    """compress_tiled through the batched lanes, with one lane past the span
    cap (a spike), gives the reference's GWTC bytes."""
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (12, 16, 18)).astype(np.float32)
    x[2, 3, 4] = 1e4  # codes of +-1e5 at abs_eb 0.05: that lane's span > 2**16
    tiles = PT.split_tiles(PT.pad_to_tiles(torch.from_numpy(x), tile), tile)
    codes = ops.lorenzo_quant_tiles_op(tiles, 0.05).reshape(tiles.shape[0], -1)
    assert int((codes.max(1).values - codes.min(1).values).max()) >= P._LANES_SPAN
    art, _ = compress_tiled(x, tile, abs_eb=0.05, device=CPU)
    rart, _ = RT.compress_tiled(jnp.asarray(x), tile, abs_eb=0.05)
    assert art.to_bytes() == rart.to_bytes()


@pytest.mark.parametrize("budget", [2**12, 2**17, 2**20])
def test_batched_histograms_stay_within_the_budget(monkeypatch, budget):
    """512 lanes of 512 symbols, one spanning 2**16 (the batch span cap):
    with the bins budget patched small, the lanes are counted in several
    histogram calls, none of more than max(budget, its widest span) bins;
    the encode still runs once and every blob is the one-lane blob."""
    rng = np.random.default_rng(budget)
    lanes = rng.integers(-40, 41, (512, 512)).astype(np.int32)
    lanes[:64] = rng.integers(-3, 4, (64, 512))  # narrow lanes
    lanes[300] = rng.integers(-7, 8, 512)
    lanes[300, :2] = (-7, 2**16 - 8)  # span exactly 2**16: still batched
    calls, encodes = [], []
    real_hist, real_enc = ops.symbol_hist_lanes_op, ops.huffman_encode_op

    def hist(codes, lo, *, n_bins):
        calls.append((codes.shape[0], n_bins))
        return real_hist(codes, lo, n_bins=n_bins)

    def enc(lens, codes):
        encodes.append(lens.shape)
        return real_enc(lens, codes)

    monkeypatch.setattr(P, "_HIST_BINS", budget)
    monkeypatch.setattr(ops, "symbol_hist_lanes_op", hist)
    monkeypatch.setattr(ops, "huffman_encode_op", enc)
    got = P.encode_codes_lanes(torch.from_numpy(lanes), "huffman")
    assert len(calls) > 1 and sum(rows for rows, _ in calls) == 512
    assert all(rows * bins <= max(budget, bins) for rows, bins in calls), calls
    assert len(encodes) == 1
    monkeypatch.undo()
    for blob, lane in zip(got, lanes):
        assert blob == P.encode_codes(torch.from_numpy(lane), "huffman")


@pytest.mark.parametrize("spans", [[5], [3, 9, 1, 70000, 2, 2], [4] * 10 + [600] * 3])
def test_hist_batches_cover_every_lane_once(spans):
    span = np.array(spans, np.int64)
    budget = 64
    batches = P._hist_batches(span, budget)
    assert sorted(np.concatenate(batches).tolist()) == list(range(span.size))
    for rows in batches:
        assert rows.size * int(span[rows].max()) <= max(budget, int(span[rows].max()))
