"""Port parity: the tiled GWTC engine end to end.

For the same input, tile, error bound and backend, ``repro_torch`` (on the
CPU, with the plain PyTorch versions of the kernels) must write the same
GWTC bytes as ``repro``, each package must decode the other's containers to
the same bits, and region reads must equal the full decode's crop.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.data import nyx_like_field as ref_field
from repro.sz import tiled as RT
from repro_torch.data import nyx_like_field
from repro_torch.errors import CorruptContainerError, CorruptLaneError
from repro_torch.sz import artifact, compress_tiled, decompress_region, decompress_tiled
from repro_torch.sz import tiled as PT

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CPU = "cpu"


def _field(shape=(24, 20, 18), seed=1):
    return nyx_like_field(shape, "temperature", seed=seed)


def _f32_bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("backend", ["huffman+zlib", "huffman", "zlib"])
def test_container_bytes_match_reference(backend):
    x = _field()
    art, recon = compress_tiled(x, (8, 8, 8), rel_eb=1e-3, backend=backend, device=CPU)
    rart, rrecon = RT.compress_tiled(jnp.asarray(x), (8, 8, 8), rel_eb=1e-3, backend=backend)
    assert art.eb_abs == rart.eb_abs
    assert art.to_bytes() == rart.to_bytes()
    np.testing.assert_array_equal(_f32_bits(recon.numpy()), _f32_bits(rrecon))


@pytest.mark.parametrize("shape,tile", [((50,), 16), ((19, 23), (8, 5)), ((9, 10, 11), (4, 5, 3))])
def test_ranks_and_ragged_tiles_match_reference(shape, tile):
    x = np.random.default_rng(len(shape)).normal(100, 20, shape).astype(np.float32)
    art, _ = compress_tiled(x, tile, abs_eb=0.05, device=CPU)
    rart, rrecon = RT.compress_tiled(jnp.asarray(x), tile, abs_eb=0.05)
    assert art.to_bytes() == rart.to_bytes()
    out = decompress_tiled(PT.TiledCompressed.from_bytes(rart.to_bytes()), device=CPU)
    np.testing.assert_array_equal(_f32_bits(out.numpy()), _f32_bits(rrecon))


def test_each_package_decodes_the_others_container():
    x = _field(seed=4)
    port_blob = compress_tiled(x, (8, 8, 8), rel_eb=5e-4, device=CPU)[0].to_bytes()
    ref_blob = RT.compress_tiled(jnp.asarray(x), (8, 8, 8), rel_eb=5e-4)[0].to_bytes()
    from_port = RT.decompress_tiled(RT.TiledCompressed.from_bytes(port_blob))
    from_ref = decompress_tiled(PT.TiledCompressed.from_bytes(ref_blob), device=CPU)
    np.testing.assert_array_equal(_f32_bits(from_port), _f32_bits(from_ref.numpy()))


def test_golden_gwtc_v1_decodes_bitexact():
    with open(os.path.join(GOLDEN, "gwtc_v1.bin"), "rb") as f:
        blob = f.read()
    art = artifact.from_bytes(blob)  # sniffs the magic
    assert isinstance(art, PT.TiledCompressed) and art.predictor == "lorenzo"
    want = np.load(os.path.join(GOLDEN, "gwtc_v1_decode.npy"))
    np.testing.assert_array_equal(_f32_bits(decompress_tiled(art, device=CPU).numpy()),
                                  _f32_bits(want))
    # a buffer opens lazily behind a LaneStore and decodes the same
    lazy = PT.TiledCompressed.from_bytes(memoryview(blob))
    assert isinstance(lazy.tile_blobs, PT.LaneStore)
    np.testing.assert_array_equal(decompress_tiled(lazy, device=CPU).numpy(), want)


@pytest.mark.parametrize("roi", [
    [(3, 21), (1, 19), (5, 17)],
    [slice(0, 8), slice(8, 16), slice(0, 18)],
    [(-5, -1), (0, 20), (7, 8)],
])
def test_region_equals_full_crop(roi):
    art, recon = compress_tiled(_field(seed=2), (8, 8, 8), rel_eb=1e-3, device=CPU)
    full = decompress_tiled(art, device=CPU)
    assert torch.equal(full, recon)
    bounds = PT.normalize_roi(roi, art.shape)
    crop = full[tuple(slice(a, b) for a, b in bounds)]
    assert torch.equal(decompress_region(art, roi, device=CPU), crop)
    # the reference decodes the same region from the port's bytes
    rart = RT.TiledCompressed.from_bytes(art.to_bytes())
    np.testing.assert_array_equal(_f32_bits(RT.decompress_region(rart, roi)),
                                  _f32_bits(crop.numpy()))


def test_flipped_lane_byte_raises_or_quarantines():
    art, recon = compress_tiled(_field(seed=3), (8, 8, 8), rel_eb=1e-3, device=CPU)
    blob = bytearray(art.to_bytes())
    lane = 5
    off = PT.lane_offset(PT.TiledCompressed.from_bytes(bytes(blob)), lane)
    blob[off + 10] ^= 0x40
    bad = PT.TiledCompressed.from_bytes(bytes(blob))
    with pytest.raises(CorruptLaneError) as e:
        decompress_tiled(bad, device=CPU)
    assert e.value.tile_id == lane
    q = PT.TiledCompressed.from_bytes(bytes(blob))
    q.on_corrupt, q.fill_value = "quarantine", -1.0
    out, n_good, mask = PT.decode_lanes(q, range(q.n_tiles), with_mask=True, device=CPU)
    assert n_good == q.n_tiles - 1 and mask.tolist() == [i == lane for i in range(q.n_tiles)]
    assert bool((out[lane] == -1.0).all())
    good = PT.split_tiles(PT.pad_to_tiles(recon, q.tile), q.tile)
    keep = [i for i in range(q.n_tiles) if i != lane]
    assert torch.equal(out[keep], good[keep])


def test_corrupt_containers_raise_structured_errors():
    blob = compress_tiled(_field(), (8, 8, 8), rel_eb=1e-3, device=CPU)[0].to_bytes()
    with pytest.raises(CorruptContainerError):
        PT.TiledCompressed.from_bytes(b"XXXX" + blob[4:])
    with pytest.raises(CorruptContainerError):
        PT.TiledCompressed.from_bytes(blob[:-3])
    damaged = bytearray(blob)
    damaged[8] ^= 1  # header byte: metadata CRC
    with pytest.raises(CorruptContainerError):
        PT.TiledCompressed.from_bytes(bytes(damaged))
    with pytest.raises(CorruptContainerError):
        artifact.from_bytes(b"ZZZZ1234")


def test_slice_end_to_end_nyx():
    """The whole slice on a small Nyx-like field: same field bits as the
    reference, same container bytes, the bound holds, and every decode
    route gives the compress-time reconstruction."""
    x = nyx_like_field((40, 36, 28), "temperature", seed=0)
    np.testing.assert_array_equal(x, ref_field((40, 36, 28), "temperature", seed=0))
    art, recon = compress_tiled(x, 16, rel_eb=1e-3, device=CPU)
    rart, _ = RT.compress_tiled(jnp.asarray(x), (16, 16, 16), rel_eb=1e-3)
    blob = art.to_bytes()
    assert blob == rart.to_bytes() and art.nbytes == len(blob)
    out = decompress_tiled(PT.TiledCompressed.from_bytes(blob), device=CPU)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert torch.equal(out, recon)
    assert float(np.abs(out.numpy().astype(np.float64) - x).max()) <= art.eb_abs * (1 + 1e-6)
    assert len(blob) < x.nbytes / 4
