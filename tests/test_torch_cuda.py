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

from repro_torch.kernels import enhancer_fused, ops, ref
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
    sz_kernels = ("lorenzo_quant_tiles", "symbol_hist", "huffman_encode", "huffman_decode")
    assert all(ops.LAUNCHES[k] > 0 for k in sz_kernels), ops.LAUNCHES


@pytest.mark.parametrize("G", [1, 20, 4096])
def test_group_hist_kernel_matches_plain_version(cuda, G):
    rng = np.random.default_rng(G)
    edges = np.sort(rng.normal(0, 1, G + 1)).astype(np.float32)
    if G > 2:
        edges[2] = edges[1]  # a duplicate edge
    x = np.concatenate([rng.normal(0, 1.5, 100003), edges, [edges[0] - 1, edges[-1] + 1,
                                                            np.nan]]).astype(np.float32)
    xt, et = torch.from_numpy(x).to(cuda), torch.from_numpy(edges).to(cuda)
    ids, hist = ops.group_hist_op(xt.reshape(-1, 1), et)
    want_ids, want_hist = ref.group_hist_ref(xt.reshape(-1, 1), et)
    assert torch.equal(ids, want_ids) and torch.equal(hist, want_hist)
    assert int(hist.sum()) == x.size


def _random_enhancers(rng, G, C, device):
    f = lambda *s: torch.from_numpy(rng.normal(0, 0.5, s).astype(np.float32)).to(device)
    lo = torch.from_numpy(np.sort(rng.normal(0, 1, G)).astype(np.float32)).to(device)
    scale = f(G).abs() + 0.1
    rscale = f(G).abs()
    rscale[0] = 0.0  # an inactive group
    return enhancer_fused.pack_enhancers(lo, scale, f(G), rscale, f(G, 9, C), f(G, C),
                                         f(G, C).abs(), f(G, C), f(G, 9, C))


@pytest.mark.parametrize("mode,clamp", [("pred", None), ("residual", None),
                                        ("residual", 0.05), ("direct", None)])
def test_enhancer_grouped_kernel_matches_plain_version(cuda, mode, clamp):
    rng = np.random.default_rng(3)
    G, C = 6, 9
    packed = _random_enhancers(rng, G, C, cuda)
    x = torch.from_numpy(rng.normal(0, 1, (5, 45, 70)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, G, x.shape).astype(np.int32)).to(cuda)
    got = ops.enhancer_grouped_op(x, ids, packed, mode=mode, clamp_eb=clamp)
    want = ref.enhancer_grouped_ref(x, ids, packed, mode=mode, clamp_eb=clamp)
    # the kernel fuses multiply-adds the plain version rounds twice
    assert float((got - want).abs().max()) <= 1e-5 * (1 + float(want.abs().max()))
    # any subset of slices enhances to the same bits
    assert torch.equal(ops.enhancer_grouped_op(x[2:4], ids[2:4], packed, mode=mode,
                                               clamp_eb=clamp), got[2:4])


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 3, 100), (3, 17, 45), (2, 64, 64)])
def test_enhancer_fused_kernel_matches_plain_version(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    C = 9
    f = lambda *s: torch.from_numpy(rng.normal(0, 0.5, s).astype(np.float32)).to(cuda)
    params = {"w1": f(3, 3, 1, C), "b1": f(C), "gamma": f(C) + 1, "beta": f(C),
              "w2": f(3, 3, C, 1), "b2": f(1)}
    state = {"mean": f(C), "var": f(C).abs() + 0.5}
    x = f(*shape)
    got = ops.enhancer_fused_op(x, params, state)
    want = ref.enhancer_fused_ref(x, *(params[k] for k in ("w1", "b1", "gamma", "beta")),
                                  state["mean"], state["var"], params["w2"], params["b2"])
    assert float((got - want).abs().max()) <= 1e-5 * (1 + float(want.abs().max()))


def test_gwlz_on_the_card_matches_the_cpu(cuda):
    from repro_torch.core.pipeline import GWLZ, GWLZTrainConfig
    from repro_torch.data import nyx_like_field
    from repro_torch.sz import SZCompressor, TiledCompressed

    x = nyx_like_field((32, 32, 32), "temperature", seed=7)
    gw = GWLZ(sz=SZCompressor("lorenzo"), train_cfg=GWLZTrainConfig(n_groups=4, epochs=2))
    ops.reset_launches()
    art, stats = gw.compress_tiled(x, 16, rel_eb=1e-3)
    assert ops.LAUNCHES["group_hist"] > 0 and ops.LAUNCHES["enhancer_fused"] > 0
    assert stats.psnr_gwlz >= stats.psnr_sz - 1e-3
    back = TiledCompressed.from_bytes(art.to_bytes())
    full = gw.decompress_tiled(back)
    roi = [(3, 20), (0, 17), (5, 32)]
    assert torch.equal(gw.decompress_region(back, roi), full[3:20, 0:17, 5:32])
    # the same model on the CPU's plain versions: the enhancer's float sums
    # differ, then x + rhat may round to the next float
    cpu = gw.decompress_tiled(back, device="cpu")
    diff = (full.cpu() - cpu).abs()
    assert bool((diff <= 1e-5 * art.eb_abs + torch.from_numpy(np.spacing(np.abs(x)))).all())


@pytest.mark.parametrize("shape", [(33, 17, 45), (64, 64, 64), (1, 9, 40), (70,), (9, 45), ()])
def test_whole_volume_lorenzo_kernel_matches_plain_version(cuda, shape):
    """Z across segment borders (32 planes a block), ragged windows, ranks
    0-2, exact .5 ties of x / 2eb and |q| past 2^24."""
    rng = np.random.default_rng(len(shape))
    two = float(np.float32(0.75) * 2)
    x = (rng.integers(-4000, 4000, shape) + 0.5) * two
    if len(shape) == 3:
        x[0] = rng.uniform(-1, 1, shape[1:]) * 3e8 * two
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
    ops.reset_launches()
    got = ops.lorenzo_quant_op(xt, 0.75)
    assert ops.LAUNCHES["lorenzo_quant"] == 1
    assert torch.equal(got, ref.lorenzo_quant_ref(xt, 0.75))
    with pytest.raises(ValueError, match="rank"):
        ops.lorenzo_quant_op(xt.reshape(1, 1, 1, -1), 0.75)


def test_szjx_on_the_card_matches_the_cpu(cuda, tmp_path):
    from repro_torch import api
    from repro_torch.sz import SZCompressor

    rng = np.random.default_rng(8)
    x = np.exp(rng.normal(8, 1, (40, 36, 28))).astype(np.float32)
    ops.reset_launches()
    card, recon = SZCompressor("lorenzo").compress(x, rel_eb=1e-3)
    assert all(ops.LAUNCHES[k] > 0 for k in ("lorenzo_quant", "huffman_encode")), ops.LAUNCHES
    assert ops.LAUNCHES["lorenzo_quant_tiles"] == 0
    cpu, _ = SZCompressor("lorenzo").compress(x, rel_eb=1e-3, device="cpu")
    assert card.to_bytes() == cpu.to_bytes()
    vol = api.compress(x, eb=1e-3, predictor="lorenzo")
    api.save(tmp_path / "v.szjx", vol)
    with api.open(tmp_path / "v.szjx") as back:
        full = np.asarray(back)
        assert np.array_equal(full, recon.cpu().numpy())
        assert np.array_equal(back[3:20, :, 5], full[3:20, :, 5])
