"""Port parity: whole-volume Lorenzo (the ``lorenzo_quant`` kernel's plain
version), the monolithic SZJX container and monolithic GWLZ.

The same numpy inputs go through ``repro`` (JAX; the Pallas kernel in
interpret mode, or its jnp oracle) and ``repro_torch`` on the CPU.
Tolerances:

* Lorenzo codes, SZJX bytes and SZ decodes: bit-exact.
* GWLZ from the reference's init: per-step losses within rtol 1e-5 (the
  same float32 arithmetic in another summation order); model blobs
  round-trip byte-identical in both packages; enhanced decodes of one
  artifact in the two packages within 1e-5 eb + 1 spacing(x) (the SZ
  decode is bit-exact and group ids integer-exact, so they differ only in
  the enhancer's float sums, ~1e-6 of the prediction times rscale ~ eb,
  after which x + rhat may round to the next float).
"""
import functools
import os
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import enhancer as RE
from repro.core import pipeline as RP
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.sz import predictor as rpred
from repro.sz import szjax as RS
from repro_torch.core import pipeline as PP
from repro_torch.data import nyx_like_field
from repro_torch.kernels import ops, ref
from repro_torch.sz import predictor
from repro_torch.sz import szjax as PS

EB = 0.75
TWO_EB = float(np.float32(EB) * 2)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CPU = "cpu"


def _rng(case: str):
    return np.random.default_rng(zlib.crc32(case.encode()))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# lorenzo_quant: the plain version against the Pallas kernel and the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 13, 37), (16, 8, 8), (24, 5, 33)])
def test_lorenzo_quant_matches_pallas_kernel(shape):
    """Z a multiple of the Pallas kernel's block (8) and |q| < 2^24, where
    its float32 differences are exact."""
    x = _rng(str(shape)).normal(0, 400, shape).astype(np.float32)
    got = ops.lorenzo_quant_op(torch.from_numpy(x), EB).numpy()
    want = rops.lorenzo_quant_op(jnp.asarray(x), EB, use_pallas=True, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(ref.lorenzo_quant_ref(torch.from_numpy(x), EB).numpy(), got)


def _oracle_case(case: str) -> np.ndarray:
    rng = _rng(case)
    if case == "odd_shape":
        return rng.normal(0, 40, (5, 13, 37)).astype(np.float32)
    if case == "ties_negatives":  # exact .5 ties of x / 2eb, both signs
        return ((rng.integers(-5000, 5000, (3, 7, 9)) + 0.5) * TWO_EB).astype(np.float32)
    if case == "q_above_2^24":  # the Pallas kernel parts from the oracle here
        return (rng.uniform(-1, 1, (6, 7, 9)) * 3e8 * TWO_EB).astype(np.float32)
    if case == "single_plane":
        return rng.normal(0, 40, (1, 17, 45)).astype(np.float32)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["odd_shape", "ties_negatives", "q_above_2^24",
                                  "single_plane"])
def test_lorenzo_quant_matches_oracle(case):
    x = _oracle_case(case)
    got = ops.lorenzo_quant_op(torch.from_numpy(x), EB).numpy()
    np.testing.assert_array_equal(got, np.asarray(rref.lorenzo_quant_ref(jnp.asarray(x), EB)))


@pytest.mark.parametrize("shape", [(70,), (17, 45)])
def test_low_rank_lorenzo_encode_matches_reference(shape):
    x = _rng(str(shape)).normal(0, 40, shape).astype(np.float32)
    got = predictor.lorenzo_encode(torch.from_numpy(x), EB).numpy()
    np.testing.assert_array_equal(got, np.asarray(rpred.lorenzo_encode(jnp.asarray(x), EB)))


def test_lorenzo_encode_dispatches_to_lorenzo_quant(monkeypatch):
    """The whole-volume encode is the op's caller: CPU tensors take the plain
    version, anything else the kernel wrapper (which raises for rank 4)."""
    calls = []
    monkeypatch.setattr(ops, "lorenzo_quant", lambda x, eb: calls.append("kernel"))
    monkeypatch.setattr(ops.ref, "lorenzo_quant_ref", lambda x, eb: calls.append("plain"))
    predictor.lorenzo_encode(torch.zeros(2, 3, 4), EB)
    with pytest.raises(ValueError, match="meta"):
        predictor.lorenzo_encode(torch.empty(2, 3, 4, device="meta"), EB)
    assert calls == ["plain"]


def test_kernel_wrapper_refuses_what_it_cannot_take():
    from repro_torch.kernels.lorenzo_quant import lorenzo_quant

    with pytest.raises(ValueError, match="CUDA"):
        lorenzo_quant(torch.zeros(2, 3, 4), EB)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="rank"):
            lorenzo_quant(torch.zeros(1, 2, 3, 4, device="cuda"), EB)


# ---------------------------------------------------------------------------
# SZJX
# ---------------------------------------------------------------------------


def _field(shape, seed=0):
    return nyx_like_field(shape, "temperature", seed=seed) if len(shape) == 3 else (
        np.cumsum(np.random.default_rng(seed).normal(0, 5, shape), axis=-1)
        .astype(np.float32))


@pytest.mark.parametrize("backend", ["huffman", "huffman+zlib", "zlib"])
@pytest.mark.parametrize("shape", [(300,), (20, 33), (12, 20, 9)])
def test_szjx_bytes_match_reference(backend, shape):
    x = _field(shape, seed=len(shape))
    art, recon = PS.SZCompressor("lorenzo", backend=backend).compress(x, rel_eb=1e-3,
                                                                      device=CPU)
    rart, rrecon = RS.SZCompressor("lorenzo", backend=backend).compress(
        jnp.asarray(x), rel_eb=1e-3)
    assert art.to_bytes() == rart.to_bytes()
    np.testing.assert_array_equal(_bits(recon.numpy()), _bits(rrecon))
    assert np.abs(recon.numpy() - x).max() <= art.eb_abs * (1 + 1e-6)


def test_each_package_opens_the_others_szjx():
    x = _field((12, 20, 9), seed=5)
    pblob = PS.compress(x, abs_eb=0.5, predictor="lorenzo", device=CPU)[0].to_bytes()
    rblob = RS.compress(jnp.asarray(x), abs_eb=0.5, predictor="lorenzo")[0].to_bytes()
    for blob in (pblob, rblob):
        got = PS.decompress(PS.SZCompressed.from_bytes(blob), device=CPU).numpy()
        want = RS.decompress(RS.SZCompressed.from_bytes(blob))
        np.testing.assert_array_equal(_bits(got), _bits(want))
    # a buffer (as api.open passes an mmap) parses like bytes
    assert PS.SZCompressed.from_bytes(memoryview(pblob)).to_bytes() == pblob


def test_golden_szjx_lorenzo_decodes_bitexact():
    with open(os.path.join(GOLDEN, "szjx_lorenzo.bin"), "rb") as f:
        art = PS.SZCompressed.from_bytes(f.read())
    out = PS.decompress(art, device=CPU).numpy()
    np.testing.assert_array_equal(_bits(out),
                                  _bits(np.load(os.path.join(GOLDEN, "szjx_lorenzo_decode.npy"))))


def test_interp_predictor_is_not_ported():
    x = _field((8, 8, 8))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        PS.SZCompressor().compress(x, rel_eb=1e-3, device=CPU)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        PS.SZCompressor().compress_tiled(x, 4, rel_eb=1e-3, device=CPU)
    with open(os.path.join(GOLDEN, "szjx_interp.bin"), "rb") as f:
        art = PS.SZCompressed.from_bytes(f.read())  # parses; decoding needs interp
    assert art.predictor == "interp"
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        PS.decompress(art, device=CPU)


def test_corrupt_szjx_raises_container_error():
    from repro_torch.errors import CorruptContainerError

    blob = PS.compress(_field((6, 7, 8)), abs_eb=1.0, predictor="lorenzo",
                       device=CPU)[0].to_bytes()
    for bad in (b"XXXX" + blob[4:], blob[:30]):
        with pytest.raises(CorruptContainerError):
            PS.SZCompressed.from_bytes(bad)


# ---------------------------------------------------------------------------
# monolithic GWLZ (16 slices of 40 x 48, G = 4, one step an epoch)
# ---------------------------------------------------------------------------

CFG = dict(n_groups=4, epochs=5)
ROI = ((3, 11), (5, 40), (0, 17))


@pytest.fixture(scope="module")
def mono_field():
    return nyx_like_field((16, 40, 48), "temperature", seed=11)


@pytest.fixture(scope="module")
def mono_ref(mono_field):
    gw = RP.GWLZ(sz=RS.SZCompressor(predictor="lorenzo"), train_cfg=RP.GWLZTrainConfig(**CFG))
    art, stats = gw.compress(jnp.asarray(mono_field), rel_eb=1e-3)
    return gw, art.to_bytes(), stats


@pytest.fixture(scope="module")
def mono_port(mono_field):
    """The port's GWLZ.compress, trained from the reference's init (torch
    cannot draw ``jax.random``'s numbers)."""
    keys = jax.random.split(jax.random.PRNGKey(0), CFG["n_groups"])
    params = {k: np.asarray(v) for k, v in
              jax.vmap(lambda k: RE.init_params(k, 9))(keys).items()}
    gw = PP.GWLZ(sz=PS.SZCompressor(predictor="lorenzo"), train_cfg=PP.GWLZTrainConfig(**CFG))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PP, "train_enhancers", functools.partial(PP.train_enhancers, params=params))
        art, stats = gw.compress(mono_field, rel_eb=1e-3, device=CPU)
    return gw, art.to_bytes(), stats


def test_mono_training_losses_track_reference(mono_ref, mono_port):
    """16 slices at batch 10: one step an epoch, so each epoch's loss is one
    step's."""
    np.testing.assert_allclose(mono_port[2].loss_history, mono_ref[2].loss_history, rtol=1e-5)
    assert mono_port[2].loss_history.shape == (CFG["epochs"], CFG["n_groups"])


def test_mono_sz_half_is_byte_identical(mono_ref, mono_port):
    rart = RS.SZCompressed.from_bytes(mono_ref[1])
    part = PS.SZCompressed.from_bytes(mono_port[1])
    assert part.code_blob == rart.code_blob
    assert mono_port[2].psnr_sz == pytest.approx(mono_ref[2].psnr_sz, abs=1e-4)
    assert mono_port[2].cr_sz == mono_ref[2].cr_sz


def test_mono_model_blob_round_trips_both_ways(mono_ref, mono_port):
    for blob in (PS.SZCompressed.from_bytes(mono_port[1]).extras["gwlz"],
                 RS.SZCompressed.from_bytes(mono_ref[1]).extras["gwlz"]):
        assert RP.serialize_model(RP.deserialize_model(blob)) == blob
        assert PP.serialize_model(PP.deserialize_model(blob, device=CPU)) == blob


def test_mono_each_package_decodes_the_others_artifact(mono_field, mono_ref, mono_port):
    eb = mono_ref[2].eb_abs
    for blob in (mono_ref[1], mono_port[1]):
        got = mono_port[0].decompress(PS.SZCompressed.from_bytes(blob), device=CPU).numpy()
        want = np.asarray(mono_ref[0].decompress(RS.SZCompressed.from_bytes(blob)))
        assert got.shape == want.shape == mono_field.shape
        assert (np.abs(got - want) <= 1e-5 * eb + np.spacing(np.abs(mono_field))).all()


def test_mono_port_decode_region_and_stats(mono_field, mono_port):
    gw, blob, stats = mono_port
    art = PS.SZCompressed.from_bytes(blob)
    full = gw.decode(art, device=CPU)
    from repro_torch.core import metrics

    assert float(metrics.psnr(torch.from_numpy(mono_field), full)) == stats.psnr_gwlz
    assert stats.psnr_gwlz >= stats.psnr_sz - 1e-3
    assert set(stats.seconds) == {"sz", "edges", "train", "calibrate", "gate", "enhance"}
    region = gw.decode(art, ROI, device=CPU)
    assert torch.equal(region, full[tuple(slice(a, b) for a, b in ROI)])


def test_quick_compress_takes_the_reference_defaults(mono_field):
    """The reference's quick_compress runs its default SZCompressor (interp),
    which the port does not have yet."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        PP.quick_compress(mono_field, epochs=1, device=CPU)
