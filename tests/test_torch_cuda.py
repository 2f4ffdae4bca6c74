"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports neither ``jax`` nor ``repro``, so it also runs where only
the port is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one (the kernels have no
CPU mode; the CPU parity tests are the other ``tests/test_torch_*.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.sz import compress_tiled, decompress_region, decompress_tiled, entropy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_lorenzo_kernel_matches_plain_version(cuda):
    rng = np.random.default_rng(0)
    for shape in [(2, 5, 13, 37), (3, 64, 64, 64), (4, 70), (3, 9, 45)]:
        x = torch.from_numpy(rng.normal(0, 50, shape).astype(np.float32)).to(cuda)
        assert torch.equal(ops.lorenzo_quant_tiles_op(x, 0.75),
                           ref.lorenzo_quant_tiles_ref(x, 0.75))


@pytest.mark.parametrize("n_bins", [64, 5000, 100000])
def test_symbol_hist_kernel_matches_plain_version(cuda, n_bins):
    s = torch.from_numpy(np.random.default_rng(n_bins).integers(-9, n_bins + 9, 70001)
                         .astype(np.int32)).to(cuda)
    assert torch.equal(ops.symbol_hist_op(s, n_bins=n_bins), ref.symbol_hist_ref(s, n_bins))


@pytest.mark.parametrize("cs", [8, 256, 1000])
def test_huffman_kernels_match_plain_versions(cuda, cs):
    sizes = [2**i for i in range(14, 0, -1)] + [1, 1]  # codes past the 12-bit LUT
    codes = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    np.random.default_rng(cs).shuffle(codes)
    flat = torch.from_numpy(codes).to(cuda)
    codec = entropy.HuffmanCodec.fit(flat)
    lens, cws = codec._pack_inputs(flat, cs)
    words, bits = ops.huffman_encode_op(lens, cws)
    want_words, want_bits = ref.huffman_encode_ref(lens, cws)
    assert torch.equal(words, want_words) and torch.equal(bits, want_bits)
    blob = entropy.encode_codes(flat, "huffman", chunk_size=cs)
    assert blob == entropy.encode_codes(torch.from_numpy(codes), "huffman", chunk_size=cs)
    c2, n, cs2, chunk_bits, stream, _ = entropy.parse_chunked(blob)
    cb = np.asarray(chunk_bits, np.int64)
    args, kw = c2._decode_inputs(stream, n, cs2, np.cumsum(cb) - cb, cuda)
    assert torch.equal(ops.huffman_decode_op(*args, **kw), ref.huffman_decode_ref(*args, **kw))
    assert torch.equal(entropy.decode_codes(blob, codes.shape, device=cuda).cpu(),
                       torch.from_numpy(codes))


def test_tiled_slice_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(6)
    x = np.exp(rng.normal(8, 1, (40, 36, 28))).astype(np.float32)
    ops.reset_launches()
    card, recon = compress_tiled(x, 16, rel_eb=1e-3)
    cpu, _ = compress_tiled(x, 16, rel_eb=1e-3, device="cpu")
    assert card.to_bytes() == cpu.to_bytes()
    full = decompress_tiled(card)
    assert torch.equal(full, recon)
    roi = [(3, 37), (5, 20), (0, 28)]
    assert torch.equal(decompress_region(card, roi), full[3:37, 5:20, 0:28])
    assert all(v > 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES
