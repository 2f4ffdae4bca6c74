"""Port parity: prequantize + per-tile Lorenzo codes and their decode.

The same numpy inputs go through ``repro`` (JAX, the Pallas kernel in
interpret mode and its jnp oracle) and ``repro_torch`` (the plain PyTorch
version that CPU tensors dispatch to).  All comparisons are bit-exact.
"""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.sz import predictor as rpred
from repro_torch.kernels import ops, ref
from repro_torch.sz import predictor, quantizer

EB = 0.75
TWO_EB = float(np.float32(EB) * 2)


def _tiles(case: str) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case == "ties_negatives":  # exact .5 ties of x / 2eb, both signs
        k = rng.integers(-5000, 5000, (3, 6, 5, 7))
        return ((k + 0.5) * TWO_EB).astype(np.float32)
    if case == "ragged_tile":
        return rng.normal(0, 40, (2, 5, 13, 37)).astype(np.float32)
    if case == "cube":
        return rng.normal(0, 40, (4, 8, 8, 8)).astype(np.float32)
    if case == "rank1":
        return rng.normal(0, 40, (5, 19)).astype(np.float32)
    if case == "rank2":
        return rng.normal(0, 40, (3, 6, 11)).astype(np.float32)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["ties_negatives", "ragged_tile", "cube", "rank1", "rank2"])
def test_lorenzo_codes_match_reference(case):
    x = _tiles(case)
    got = ops.lorenzo_quant_tiles_op(torch.from_numpy(x), EB).numpy()
    np.testing.assert_array_equal(got, np.asarray(rref.lorenzo_quant_tiles_ref(jnp.asarray(x), EB)))
    # the reference dispatcher with the Pallas kernel in interpret mode (rank-3
    # tiles; other ranks take its jnp path, as on a TPU)
    want = rops.lorenzo_quant_tiles_op(jnp.asarray(x), EB, use_pallas=True, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_ties_round_half_to_even():
    x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5]], np.float32) * TWO_EB
    q = quantizer.prequantize(torch.from_numpy(x), EB).numpy()
    np.testing.assert_array_equal(q, [[0, 2, 2, 0, -2, -2]])


def test_large_q_follows_the_oracle():
    """|q| >= 2**24: the port differences in int32 like ``ref.lorenzo_quant_ref``.
    The Pallas kernel differences in float32 and parts from the oracle here
    (ROADMAP.md Queue 3), so this case is held against the oracle only."""
    rng = np.random.default_rng(5)
    x = (rng.uniform(-1, 1, (2, 6, 7, 9)) * 3e8 * TWO_EB).astype(np.float32)
    got = ops.lorenzo_quant_tiles_op(torch.from_numpy(x), EB).numpy()
    np.testing.assert_array_equal(got, np.asarray(rref.lorenzo_quant_tiles_ref(jnp.asarray(x), EB)))


@pytest.mark.parametrize("case", ["ties_negatives", "ragged_tile", "rank1"])
def test_lorenzo_decode_matches_reference(case):
    codes = np.asarray(rref.lorenzo_quant_tiles_ref(jnp.asarray(_tiles(case)), EB))
    got = ops.lorenzo_decode_tiles_op(torch.tensor(codes), EB).numpy()
    want = np.asarray(rops.lorenzo_decode_tiles_op(jnp.asarray(codes), EB))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_whole_volume_lorenzo_matches_reference():
    rng = np.random.default_rng(9)
    x = rng.normal(0, 30, (9, 10, 11)).astype(np.float32)
    codes = predictor.lorenzo_encode(torch.from_numpy(x), EB)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(rpred.lorenzo_encode(jnp.asarray(x), EB)))
    back = predictor.lorenzo_decode(codes, EB).numpy()
    want = np.asarray(rpred.lorenzo_decode(jnp.asarray(codes.numpy()), EB))
    np.testing.assert_array_equal(back.view(np.uint32), want.view(np.uint32))
    assert np.abs(back - x).max() <= EB * (1 + 1e-6)


def test_resolve_eb_matches_reference():
    from repro.sz.quantizer import resolve_eb as r_resolve

    rng = np.random.default_rng(2)
    x = np.exp(rng.normal(8, 1, (7, 8, 9))).astype(np.float32)
    for rel, ab in ((1e-3, None), (None, 0.25)):
        assert quantizer.resolve_eb(torch.from_numpy(x), rel, ab) == r_resolve(jnp.asarray(x), rel, ab)
    with pytest.raises(ValueError):
        quantizer.resolve_eb(torch.from_numpy(x), None, 1e-9)

