"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports neither ``jax`` nor ``repro``, so it also runs where only
the port is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one (the kernels have no
CPU mode; the CPU parity tests are the other ``tests/test_torch_*.py``).
"""
import os

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


LORENZO_TWO_EB = float(np.float32(0.75) * 2)
# case -> shape; rank-4 shapes are tile batches [B, Z, Y, X], the others
# (and tile 0 of each batch) whole volumes
LORENZO_EDGES = {
    "x_mod4_1": (2, 5, 9, 129), "x_mod4_2": (2, 5, 9, 130), "x_mod4_3": (2, 5, 9, 131),
    "ragged_5x13x37": (3, 5, 13, 37),  # tiles start off 16 bytes
    "x66_rows_off_16B": (4, 5, 13, 66), "x1": (3, 4, 7, 1), "z1": (3, 1, 7, 200),
    "z1_y1_x1": (5, 1, 1, 1), "ties": (3, 6, 5, 128), "q_near_2^31": (2, 9, 40, 132),
    "base_off_16B": (2, 4, 8, 512), "rank1": (4, 70), "rank2": (4, 17, 45),
}


def lorenzo_edge(case: str, rng) -> np.ndarray:
    """Values for a Lorenzo edge case: exact .5 ties of x / 2eb, |q| near
    2**31 (the int32 differences wrap), or normal noise."""
    shape = LORENZO_EDGES[case]
    if case == "ties":
        x = (rng.integers(-4000, 4000, shape) + 0.5) * LORENZO_TWO_EB
    elif case == "q_near_2^31":
        x = rng.uniform(-1, 1, shape) * 0.999 * 2**31 * LORENZO_TWO_EB
    else:
        x = rng.normal(0, 50, shape)
    return np.asarray(x, np.float32)


def _on_card(x: np.ndarray, dev, offset: bool = False) -> torch.Tensor:
    """x on the card; ``offset``: a contiguous view 4 bytes past an aligned
    allocation, so no row is 16-byte aligned."""
    if not offset:
        return torch.from_numpy(x).to(dev)
    t = torch.empty(x.size + 1, dtype=torch.float32, device=dev)[1:].view(x.shape)
    return t.copy_(torch.from_numpy(x))


@pytest.mark.parametrize("case", list(LORENZO_EDGES))
def test_lorenzo_kernels_on_edge_cases(cuda, case):
    """Both Lorenzo kernels bit for bit against their plain versions: X % 4
    of 1-3, tiles and rows off 16 bytes, X = 1, Z = 1, ranks 1-2, .5 ties,
    |q| near 2**31; the tile kernel on the batch, the volume kernel on its
    first tile."""
    x = lorenzo_edge(case, np.random.default_rng(len(case)))
    xt = _on_card(x, cuda, offset=case == "base_off_16B")
    ops.reset_launches()
    got = ops.lorenzo_quant_tiles_op(xt, 0.75)
    assert ops.LAUNCHES["lorenzo_quant_tiles"] == 1
    assert torch.equal(got, ref.lorenzo_quant_tiles_ref(xt, 0.75))
    vol = xt[0]
    assert torch.equal(ops.lorenzo_quant_op(vol, 0.75), ref.lorenzo_quant_ref(vol, 0.75))
    assert ops.LAUNCHES["lorenzo_quant"] == 1


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


@pytest.mark.parametrize("shape", [(33, 17, 45), (64, 64, 64), (1, 9, 40), (70,), (9, 45), (),
                                   (70, 9, 128), (33, 5, 66), (65, 3, 37), (31, 2, 512)])
def test_whole_volume_lorenzo_kernel_matches_plain_version(cuda, shape):
    """Z across segment borders (32 planes a warp) at each vector width (X =
    128 and 512: 4 cells a lane, 66: 2, 37 and 45: 1), ragged windows, ranks
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


def _decode_args(codec, sym, cs, device):
    """Pack ``sym`` with ``codec`` on ``device`` (the encode kernel, chunk
    sizes up to MAX_CHUNK) and return the decode op's arguments there (int64
    offsets) and the chunk bit counts."""
    stream, bits, _ = codec._device_pack(torch.from_numpy(sym).to(device), cs)
    args, kw = codec._decode_inputs(stream, sym.size, cs, np.cumsum(bits) - bits, device)
    return list(args), kw, bits


def _skewed(rng, n_sizes=17, cap=4096):
    sizes = [2 ** i for i in range(n_sizes - 2, 0, -1)] + [1, 1]
    sym = np.repeat(np.arange(len(sizes), dtype=np.int32), np.minimum(sizes, cap))
    rng.shuffle(sym)
    return sym


@pytest.mark.parametrize("case", ["cs1", "cs256", "max_chunk", "codes32_and_escapes_in_a_warp",
                                  "short_last_chunk", "wide_alphabet", "int32_offsets",
                                  "zeroed_stream", "truncated_stream"])
def test_huffman_decode_edges_match_plain_version(cuda, case):
    """The decode kernel bit for bit against its plain version on the edges
    of its design: chunk sizes 1 .. MAX_CHUNK (staging overrun), 32-bit codes
    and LUT escapes mixed among one warp's chunks, a short last chunk, an
    alphabet past the shared-memory escape tables, int32 offsets, and a
    damaged stream (which must end)."""
    from repro_torch.kernels.huffman_encode import MAX_CHUNK

    rng = np.random.default_rng(len(case))
    sym, cs = _skewed(rng), 256
    codec = entropy.HuffmanCodec.fit(torch.from_numpy(sym))
    if case == "cs1":
        sym, cs = sym[:3001], 1
    elif case == "max_chunk":
        sym, cs = np.concatenate([sym, sym[::-1], sym[:777]]), MAX_CHUNK
    elif case == "codes32_and_escapes_in_a_warp":
        fib = [1, 1] + [2 ** i for i in range(1, 45)]
        L = entropy._limited_code_lengths(np.asarray(fib, np.int64))
        assert int(L.max()) == 32
        alphabet = np.arange(L.size, dtype=np.int32)
        codec = entropy.HuffmanCodec(alphabet, L, entropy._canonical_codes(L))
        # every few chunks a run of the longest codes, between LUT hits
        sym = rng.choice(alphabet[:8], 64 * 40).astype(np.int32)
        sym[::97] = alphabet[-1]
        sym[5::61] = alphabet[-3]
        cs = 40
    elif case == "short_last_chunk":
        sym = sym[: 256 * 37 + 3]
    elif case == "wide_alphabet":
        sym = rng.integers(0, 70000, 300001).astype(np.int32)
        codec = entropy.HuffmanCodec.fit(torch.from_numpy(sym))
        assert codec.alphabet.size > 4096
    args, kw, _ = _decode_args(codec, sym, cs, cuda)
    if case == "int32_offsets":
        args[1] = args[1].to(torch.int32)
    elif case == "zeroed_stream":
        args[0] = torch.zeros_like(args[0])
    elif case == "truncated_stream":
        args[0] = args[0][: args[0].numel() // 3].clone()
        args[0][-2:] = 0
    ops.reset_launches()
    got = ops.huffman_decode_op(*args, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["huffman_decode"] == 1
    assert torch.equal(got, ref.huffman_decode_ref(*args, **kw))
    if case not in ("zeroed_stream", "truncated_stream"):
        ids = got.reshape(-1)[: sym.size].cpu().numpy()
        np.testing.assert_array_equal(codec.alphabet[ids], sym)


def test_huffman_encode_at_max_chunk_round_trips(cuda):
    """The encode kernel at MAX_CHUNK (48 KB of words in shared memory, past
    48 KB in all) packs bit for bit as its plain version, and the stream
    decodes on the card."""
    from repro_torch.kernels.huffman_encode import MAX_CHUNK

    sym = _skewed(np.random.default_rng(48))
    sym = np.concatenate([sym, sym[::-1], sym[:999]])
    flat = torch.from_numpy(sym).to(cuda)
    codec = entropy.HuffmanCodec.fit(flat)
    lens, cws = codec._pack_inputs(flat, MAX_CHUNK)
    ops.reset_launches()
    words, bits = ops.huffman_encode_op(lens, cws)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["huffman_encode"] == 1
    want_words, want_bits = ref.huffman_encode_ref(lens, cws)
    assert torch.equal(words, want_words) and torch.equal(bits, want_bits)
    blob = entropy.encode_codes(flat, "huffman", chunk_size=MAX_CHUNK)
    assert blob == entropy.encode_codes(flat.cpu(), "huffman", chunk_size=MAX_CHUNK)
    assert torch.equal(entropy.decode_codes(blob, sym.shape, device=cuda).cpu(), flat.cpu())


def test_huffman_decode_offsets_past_2_31_and_2_32_bits(cuda):
    """Chunks placed at bit offsets past 2**31 and 2**32 in a stream of
    ~600 MB of words decode bit for bit as the plain version does (64-bit
    positions throughout)."""
    rng = np.random.default_rng(31)
    sym = _skewed(rng)[: 256 * 8]
    codec = entropy.HuffmanCodec.fit(torch.from_numpy(sym))
    cs = 256
    lens, cws = codec._pack_inputs(torch.from_numpy(sym).to(cuda), cs)
    local, bits = ops.huffman_encode_op(lens, cws)
    local = local.cpu().numpy().view(np.uint32).astype(np.uint64)
    bits = bits.cpu().numpy().astype(np.int64)
    n_words = 150_000_000  # 4.8e9 bits
    # chunks at least 5,000 bits apart (one holds <= 256 x 17), two of them
    # straddling 2**31 and 2**32
    offsets = np.array([5, 2**31 - 300, 2**31 + 5003, 2**32 - 301, 2**32 + 5003,
                        2**32 + 2**20 + 31, (n_words - 400) * 32 + 7, (n_words - 200) * 32],
                       np.int64)
    assert int(bits.max()) < 5000 and bits[1] > 300 and bits[3] > 301
    words = torch.zeros(n_words, dtype=torch.int32, device=cuda)
    for c, off in enumerate(offsets):  # each chunk's bits shifted to its offset
        used = -(-int(bits[c]) // 32)
        sh = int(off & 31)
        win = np.zeros(used + 1, np.uint64)
        win[:used] = local[c, :used] >> np.uint64(sh)
        win[1:] |= (local[c, :used] << np.uint64(32 - sh)) & np.uint64(0xFFFFFFFF)
        at = int(off >> 5)
        piece = torch.from_numpy(win.astype(np.uint32).view(np.int32)).to(cuda)
        words[at : at + used + 1] |= piece
    tabs = codec._tables_on(cuda)
    counts = torch.full((offsets.size,), cs, dtype=torch.int32, device=cuda)
    args = [words, torch.from_numpy(offsets).to(cuda), counts, tabs.lut, tabs.cw_map,
            tabs.order, tabs.len_sorted]
    got = ops.huffman_decode_op(*args, chunk_size=cs, k=tabs.k)
    assert torch.equal(got, ref.huffman_decode_ref(*args, chunk_size=cs, k=tabs.k))
    np.testing.assert_array_equal(codec.alphabet[got.cpu().numpy()], sym.reshape(8, cs))


def _enhancer_case(rng, case, device):
    """(x, ids, packed) of an enhancer edge case."""
    C = {"channels_2": 2, "channels_12": 12}.get(case, 9)
    G, shape = {"channels_2": (6, (2, 45, 70)), "channels_12": (6, (2, 45, 70)),
                "nine_groups_a_neighbourhood": (9, (2, 40, 70)),
                "twenty_groups_a_block": (20, (3, 32, 32)),
                "groups_change_on_block_borders": (4, (2, 70, 90)),
                "height_1": (3, (4, 1, 77)), "width_1": (3, (4, 77, 1)),
                "off_block_sizes": (5, (3, 45, 33)),
                "G287": (287, (2, 64, 96)), "G4096": (4096, (1, 96, 96))}[case]
    packed = _random_enhancers(rng, G, C, device)
    B, H, W = shape
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    if case == "nine_groups_a_neighbourhood":
        ids = np.broadcast_to((yy % 3) * 3 + xx % 3, shape)
    elif case == "groups_change_on_block_borders":  # at x = 32, 64 and y = 32, 64, and
        ids = np.broadcast_to((xx // 32 + yy // 32 + (xx % 32 == 31)) % G, shape)  # in halos
    else:
        ids = rng.integers(0, G, shape)
    ids = np.ascontiguousarray(ids, np.int32)
    x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(device)
    return x, torch.from_numpy(ids).to(device), packed


@pytest.mark.parametrize("mode", ["pred", "residual"])
@pytest.mark.parametrize("case", ["nine_groups_a_neighbourhood", "twenty_groups_a_block",
                                  "groups_change_on_block_borders", "height_1", "width_1",
                                  "off_block_sizes", "G287", "G4096", "channels_2",
                                  "channels_12"])
def test_enhancer_grouped_edges_match_plain_version(cuda, case, mode):
    """The enhancer kernel within 1e-5 (1 + max|plain|) of its plain version on
    the edges of its design (C = 2 fills a pass with many groups, C = 12
    takes two channel chunks), and bit for bit against its own launch on a
    subset of the slices."""
    rng = np.random.default_rng(len(case))
    x, ids, packed = _enhancer_case(rng, case, cuda)
    got = ops.enhancer_grouped_op(x, ids, packed, mode=mode)
    want = ref.enhancer_grouped_ref(x, ids, packed, mode=mode)
    assert float((got - want).abs().max()) <= 1e-5 * (1 + float(want.abs().max()))
    assert torch.equal(ops.enhancer_grouped_op(x[1:], ids[1:], packed, mode=mode), got[1:])
    if case == "twenty_groups_a_block":
        assert torch.unique(ids[0]).numel() == 20


@pytest.mark.parametrize("case", ["L1", "L512", "skewed", "smem_limit", "past_smem_limit",
                                  "span_above_2^16", "misaligned_rows"])
def test_symbol_hist_lanes_kernel_matches_plain_version(cuda, case):
    """The lane histogram kernel against its plain version: one row (spread
    over the card, global merge) and 512 (a block a row), lanes piled on one
    bin, spans at the shared-memory limit and past it (global bins), and
    rows that start off a 16-byte boundary; every launch counted once."""
    from repro_torch.kernels.group_hist import SMEM_BINS, symbol_hist_lanes

    rng = np.random.default_rng(len(case))
    L, n, span = {"L1": (1, 1_000_003, 994), "L512": (512, 4096, 62),
                  "skewed": (64, 65536, 300), "smem_limit": (8, 100_000, SMEM_BINS),
                  "past_smem_limit": (8, 100_000, SMEM_BINS + 1),
                  "span_above_2^16": (4, 300_001, 70_000),
                  "misaligned_rows": (33, 4099, 500)}[case]
    lo = rng.integers(-1000, 1000, L).astype(np.int32)
    codes = lo[:, None] + rng.integers(-3, span + 3, (L, n)).astype(np.int32)
    if case == "skewed":  # most of every lane on one bin, the rest on two
        codes = np.where(rng.random((L, n)) < 0.97, lo[:, None] + 5,
                         lo[:, None] + rng.integers(0, 2, (L, n))).astype(np.int32)
    ct, lt = torch.from_numpy(codes).to(cuda), torch.from_numpy(lo).to(cuda)
    ops.reset_launches()
    got = symbol_hist_lanes(ct, lt, span)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["symbol_hist"] == 1
    assert torch.equal(got, ref.symbol_hist_lanes_ref(ct, lt, span))
    assert torch.equal(ops.symbol_hist_lanes_op(ct[:, 1:], None, n_bins=span),
                       ref.symbol_hist_lanes_ref(ct[:, 1:], None, span))


@pytest.mark.parametrize("cs", [1, 31, 255, 256, 257, 1024, 1025, "max"])
def test_huffman_encode_kernel_chunk_sizes(cuda, cs):
    """The encode kernel against its plain version in both forms (a warp a
    chunk up to WARP_MAX_CS, a block a chunk above, up to MAX_CHUNK), with
    pad slots in the last chunk and 32-bit codes among short ones."""
    from repro_torch.kernels.huffman_encode import MAX_CHUNK, huffman_encode_pack

    cs = MAX_CHUNK if cs == "max" else cs
    rng = np.random.default_rng(cs)
    fib = [1, 1] + [2 ** i for i in range(1, 45)]
    L32 = entropy._limited_code_lengths(np.asarray(fib, np.int64))
    assert int(L32.max()) == 32
    codec = entropy.HuffmanCodec(np.arange(L32.size, dtype=np.int32), L32,
                                 entropy._canonical_codes(L32))
    sym = rng.choice(np.arange(6, dtype=np.int32), 3 * cs * 9 + 5)  # pad slots at the end
    sym[::37] = L32.size - 1  # 32-bit codes
    flat = torch.from_numpy(sym).to(cuda)
    lens, cws = codec._pack_inputs(flat, cs)
    ops.reset_launches()
    words, bits = huffman_encode_pack(lens, cws)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["huffman_encode"] == 1
    want_words, want_bits = ref.huffman_encode_ref(lens, cws)
    assert torch.equal(words, want_words) and torch.equal(bits, want_bits)
    # rows that start off a 16-byte boundary take the scalar loads
    C = lens.shape[0]
    lens, cws = (t.reshape(-1)[1 : 1 + (C - 1) * cs].view(C - 1, cs) for t in (lens, cws))
    words, bits = huffman_encode_pack(lens, cws)
    want_words, want_bits = ref.huffman_encode_ref(lens, cws)
    assert torch.equal(words, want_words) and torch.equal(bits, want_bits)


def test_tiled_compress_launches_each_encode_kernel_once(cuda):
    """A tiled compress fits and packs all its lanes with one launch of each
    encode kernel, and its bytes equal the CPU's; a lane past the batch span
    cap adds one launch of each."""
    rng = np.random.default_rng(15)
    x = np.exp(rng.normal(8, 1, (48, 40, 36))).astype(np.float32)
    for spike, extra in ((False, 0), (True, 1)):
        if spike:
            x[5, 6, 7] = 5e6  # codes of ~5e5: a span past 2**16, inside the dense 2**22
        ops.reset_launches()
        card, _ = compress_tiled(x, 16, abs_eb=5.0)
        counts = dict(ops.LAUNCHES)
        assert counts["symbol_hist"] == 1 + extra and counts["huffman_encode"] == 1 + extra
        assert card.to_bytes() == compress_tiled(x, 16, abs_eb=5.0, device="cpu")[0].to_bytes()


@pytest.mark.parametrize("order", ["cubic", "linear"])
def test_interp_on_the_card_matches_the_cpu(cuda, order, tmp_path):
    """The interp predictor's single float32 operations give the same bits
    on the card as on the CPU: SZJX and GWTC bytes, reconstructions and
    decodes; region == full crop on the card; the Lorenzo kernels code the
    coarse grid and the Huffman kernels the codes.  A spike forces
    outliers (its residual is ~1 / (2 rel_eb) = 5e4 codes, past 2**15)."""
    from repro_torch import api
    from repro_torch.data import nyx_like_field
    from repro_torch.sz import SZCompressor, SZCompressed, TiledCompressed, decompress

    x = nyx_like_field((40, 36, 28), "velocity_x", seed=2)
    x[7, 9, 11] = 50 * float(np.abs(x).max())
    sz = SZCompressor(order=order)
    ops.reset_launches()
    card, recon = sz.compress(x, rel_eb=1e-5)
    assert all(ops.LAUNCHES[k] > 0 for k in ("lorenzo_quant", "symbol_hist",
                                             "huffman_encode")), ops.LAUNCHES
    cpu, cpu_recon = sz.compress(x, rel_eb=1e-5, device="cpu")
    assert card.outlier_idx.size > 0
    assert card.to_bytes() == cpu.to_bytes() and torch.equal(recon.cpu(), cpu_recon)
    back = decompress(SZCompressed.from_bytes(card.to_bytes()))
    assert torch.equal(back, recon)
    eb32 = float(np.float32(card.eb_abs))
    assert float((back.cpu().double() - torch.from_numpy(x).double()).abs().max()) <= eb32

    ops.reset_launches()
    tcard, trecon = sz.compress_tiled(x, 16, rel_eb=1e-5)
    assert ops.LAUNCHES["lorenzo_quant_tiles"] == 1
    assert ops.LAUNCHES["symbol_hist"] == 1 and ops.LAUNCHES["huffman_encode"] == 1
    tcpu, tcpu_recon = sz.compress_tiled(x, 16, rel_eb=1e-5, device="cpu")
    assert tcard.to_bytes() == tcpu.to_bytes() and torch.equal(trecon.cpu(), tcpu_recon)
    tback = TiledCompressed.from_bytes(tcard.to_bytes())
    full = decompress_tiled(tback)
    assert torch.equal(full, trecon)
    roi = [(3, 37), (5, 20), (0, 28)]
    assert torch.equal(decompress_region(tback, roi), full[3:37, 5:20, 0:28])
    vol = api.compress(x, eb=1e-5, tiled=True, tile=(16, 16, 16), order=order)
    api.save(tmp_path / "v.gwtc", vol)
    with api.open(tmp_path / "v.gwtc") as opened:
        whole = np.asarray(opened)
        assert np.array_equal(whole, full.cpu().numpy())
        assert np.array_equal(opened[3:20, :, 5], whole[3:20, :, 5])


@pytest.mark.parametrize("predictor", ["lorenzo", "interp"])
def test_stream_on_the_card_matches_the_cpu(cuda, predictor, tmp_path):
    """A streamed compress on the card (lanes packed in the device stage)
    writes the CPU stream's bytes, several batches with a short final one;
    the three encode kernels launch once per batch; a hard fault and a
    resume on the card end in the same bytes."""
    from repro_torch.data import nyx_like_field
    from repro_torch.exec import journal_path, stream_compress
    from repro_torch.runtime.fault import FailureInjector, RetryPolicy

    x = nyx_like_field((40, 40, 40), "temperature", seed=5)
    kw = dict(rel_eb=1e-3, tile=(16, 16, 16), mem_budget=1 << 20, predictor=predictor)
    ops.reset_launches()
    card = stream_compress(x, str(tmp_path / "card.gwtc"), **kw)
    launches = dict(ops.LAUNCHES)
    cpu = stream_compress(x, str(tmp_path / "cpu.gwtc"), device="cpu", **kw)
    assert card.entropy_device and not cpu.entropy_device
    assert card.n_batches > 1 and card.n_tiles % card.batch_tiles
    assert (tmp_path / "card.gwtc").read_bytes() == (tmp_path / "cpu.gwtc").read_bytes()
    assert (tmp_path / "card.gwtc").read_bytes() == \
        compress_tiled(x, 16, rel_eb=1e-3, predictor=predictor)[0].to_bytes()
    assert launches["symbol_hist"] == launches["huffman_encode"] == card.n_batches
    assert launches["lorenzo_quant_tiles"] >= card.n_batches  # interp: its coarse grids
    out = tmp_path / "killed.gwtc"
    with pytest.raises(RuntimeError, match="injected"):
        stream_compress(x, str(out), injector=FailureInjector({1}, attempts=9),
                        retry=RetryPolicy(max_attempts=2, backoff=0.0), **kw)
    assert os.path.exists(journal_path(out))
    rep = stream_compress(x, str(out), resume=True, **kw)
    assert rep.resumed_batches == 1
    assert out.read_bytes() == (tmp_path / "cpu.gwtc").read_bytes()


def _legacy_case(case: str) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    if case == "escape":  # codes past the 12-bit LUT, up to the search's depth
        sizes = [2**i for i in range(18, 0, -1)] + [1, 1]
        codes = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
        rng.shuffle(codes)
        return codes
    if case == "wide_alphabet":  # > 4,096 symbols: tables stay in global memory
        return rng.integers(-5000, 5000, size=300_000).astype(np.int32)
    if case == "one_symbol":
        return np.full(1000, -3, np.int32)
    if case == "short":
        return rng.integers(-3, 4, size=100).astype(np.int32)
    return np.round(rng.normal(0, 3, size=64**3)).astype(np.int32)  # "lane_64^3"


@pytest.mark.parametrize("case", ["escape", "wide_alphabet", "one_symbol", "short", "lane_64^3"])
def test_huffman_legacy_bounds_kernel_matches_plain_version(cuda, case):
    """The boundary pass against its plain version; the legacy blob's bytes
    equal on the card and the CPU, and its decode on the card (one boundary
    launch, one decode launch) returns the codes."""
    codes = _legacy_case(case)
    flat = torch.from_numpy(codes).to(cuda)
    blobs = {b: entropy.encode_codes_legacy(flat, b) for b in ("huffman", "huffman+zlib")}
    for backend, blob in blobs.items():
        assert blob == entropy.encode_codes_legacy(torch.from_numpy(codes), backend)
    codec = entropy.HuffmanCodec.fit(flat)
    body = blobs["huffman"][18 + len(codec.table_bytes()):]  # <Q bit count, then the stream
    tabs = codec._tables_on(cuda)
    words = entropy._stream_words(body[8:], 0, None, cuda)
    kw = dict(n_symbols=codes.size, chunk_size=entropy.DEFAULT_CHUNK)
    args = (words, tabs.cw_map, tabs.len_sorted)
    ops.reset_launches()
    got = ops.huffman_legacy_bounds_op(*args, **kw)
    assert ops.LAUNCHES["huffman_legacy"] == 1
    assert torch.equal(got, ref.huffman_legacy_bounds_ref(*args, **kw))
    for blob in blobs.values():
        ops.reset_launches()
        out = entropy.decode_codes(blob, codes.shape, device=cuda)
        assert ops.LAUNCHES["huffman_legacy"] == 1 and ops.LAUNCHES["huffman_decode"] == 1
        assert torch.equal(out.cpu(), torch.from_numpy(codes))


def test_range_decode_on_the_card(cuda):
    codes = _legacy_case("lane_64^3")
    n = codes.size
    for backend in ("huffman", "huffman+zlib"):
        blob = entropy.encode_codes(torch.from_numpy(codes), backend)
        for lo, hi in [(0, n), (0, 0), (255, 257), (256, 512), (n - 1, n), (1000, 99_999)]:
            got = entropy.decode_codes_range(blob, lo, hi, device=cuda)
            assert torch.equal(got.cpu(), torch.from_numpy(codes[lo:hi])), (backend, lo, hi)


def test_serve_http_on_the_card(cuda, tmp_path):
    """Eight client threads over HTTP against a pool of a tiled Lorenzo and
    an enhanced tiled volume: every region equals the crop of an eager
    decode through a separate handle, and the decode and enhancer kernels
    ran on the handler threads."""
    import threading

    from repro_torch import api
    from repro_torch.core.trainer import GWLZTrainConfig
    from repro_torch.data import nyx_like_field
    from repro_torch.serve import RegionServer, fetch_json, fetch_region

    x = np.asarray(nyx_like_field((48, 48, 48), "temperature", seed=2), np.float32)
    paths = {"lor": tmp_path / "lor.gwtc", "gw": tmp_path / "gw.gwtc"}
    api.save(paths["lor"], api.compress(x, eb=1e-3, tiled=True, tile=(16,) * 3,
                                        predictor="lorenzo"))
    api.save(paths["gw"], api.compress(x, eb=1e-3, tiled=True, tile=(16,) * 3,
                                       predictor="lorenzo",
                                       enhance=GWLZTrainConfig(n_groups=4, epochs=1)))
    full = {}
    for name, p in paths.items():
        with api.open(p) as v:
            full[name] = np.asarray(v).copy()
    errors = []
    ops.reset_launches()
    with RegionServer(paths, cache_bytes=1 << 20) as srv:
        def client(seed):
            rng = np.random.default_rng(seed)
            try:
                for _ in range(5):
                    lo = rng.integers(0, 32, 3)
                    hi = lo + rng.integers(1, 17, 3)
                    roi = ",".join(f"{a}:{b}" for a, b in zip(lo, hi))
                    name = ("lor", "gw")[seed % 2]
                    arr, _ = fetch_region(srv.url, name, roi)
                    want = full[name][tuple(slice(a, b) for a, b in zip(lo, hi))]
                    assert np.array_equal(arr, want), (name, roi)
            except Exception as e:  # surfaced below
                errors.append(e)

        ts = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        m = fetch_json(srv.url, "/metrics")
    assert not errors, errors[0]
    assert m["requests"] == 40 and m["errors"] == 0
    assert all(ops.LAUNCHES[k] > 0 for k in ("huffman_decode", "group_hist", "enhancer_fused"))


def test_gwds_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A GWDS envelope written on the card (one whole field, one streamed
    into the shared sink) has the CPU's bytes and decodes on the card to the
    CPU's values; a dataset's fields decode on its device."""
    from repro_torch import api
    from repro_torch.data import nyx_like_field
    from repro_torch.exec import GWDSWriter, stream_compress

    x = nyx_like_field((40, 40, 40), "temperature", seed=6)
    kw = dict(rel_eb=1e-3, tile=(16, 16, 16), mem_budget=1 << 20)
    for dev in ("cuda", "cpu"):
        vol = api.compress(x, eb=1e-3, tiled=True, tile=(16,) * 3, predictor="lorenzo",
                           device=dev)
        w = GWDSWriter(tmp_path / f"{dev}.gwds")
        w.add_field("t", vol)
        gw = w.stream_field("s", shape=x.shape, tile=(16,) * 3, eb_abs=vol.eb_abs)
        ops.reset_launches()
        stream_compress(x, gw, device=dev, **kw)
        if dev == "cuda":
            assert ops.LAUNCHES["huffman_encode"] > 0
        w.finalize()
    blob = (tmp_path / "cuda.gwds").read_bytes()
    assert blob == (tmp_path / "cpu.gwds").read_bytes()
    with api.open(tmp_path / "cuda.gwds") as ds, \
            api.open(tmp_path / "cpu.gwds", device="cpu") as cds:
        assert ds["s"].device.type == "cuda"
        ops.reset_launches()
        for name in ("t", "s"):
            assert np.array_equal(np.asarray(ds[name]), np.asarray(cds[name]))
        assert ops.LAUNCHES["huffman_decode"] > 0


def test_checkpoint_gwlz_leaves_on_the_card(cuda, tmp_path):
    """compress_tensor on the card (both branches: the SZ one for a 2-D
    leaf at any size, the GWLZ one for a 3-D leaf) decodes within the
    bound, and its blob decodes on the CPU; the async save compresses on
    its own thread and restores onto the card."""
    from repro_torch.checkpoint import CheckpointManager, compress_tensor, decompress_tensor

    g = torch.Generator(device="cuda").manual_seed(1)
    w = torch.randn(256, 384, generator=g, device="cuda") * 0.02
    eb = 1e-4 * float(w.max() - w.min())
    bound = eb * (1 + 1e-5) + 2.0**-23 * float(w.abs().max())
    ops.reset_launches()
    for v, kw in ((w, dict()), (w, dict(enhance_threshold=0, epochs=1)),
                  (w.reshape(2, 128, 384), dict(enhance_threshold=0, epochs=1))):
        blob = compress_tensor(v, **kw)
        back = decompress_tensor(blob)
        assert back.device.type == "cuda" and back.shape == v.shape
        assert float((back - v).abs().max()) <= bound
        cpu = decompress_tensor(blob, device="cpu")
        assert float((cpu - v.cpu()).abs().max()) <= bound
    assert ops.LAUNCHES["group_hist"] > 0 and ops.LAUNCHES["enhancer_fused"] > 0
    state = {"w": w, "emb": torch.randn(300, 256, generator=g, device="cuda").to(torch.bfloat16),
             "step": torch.tensor(3, device="cuda")}
    m = CheckpointManager(tmp_path, gwlz_rel_eb=1e-4, async_save=True)
    m.save(1, state)
    state["w"].mul_(2.0)  # the host copy was taken before save returned
    m.wait()
    out = m.restore({k: torch.zeros_like(v) for k, v in state.items()})
    assert all(v.device.type == "cuda" for v in out.values())
    assert out["emb"].dtype == torch.bfloat16 and int(out["step"]) == 3
    assert float((out["w"] - w / 2).abs().max()) <= bound


def test_resilient_loop_on_the_card_replays_exactly(cuda, tmp_path):
    """The enhancer's training step under ResilientLoop on the card: a run
    with two injected failures ends bit for bit equal to a clean run (cuDNN
    deterministic)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.enhancer import GroupEnhancers
    from repro_torch.core.trainer import train_step
    from repro_torch.optim import adamw
    from repro_torch.runtime import FailureInjector, ResilientLoop

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    xs = torch.rand(16, 32, 32, generator=g, device=dev)
    rs = 0.01 * torch.randn(16, 32, 32, generator=g, device=dev)
    edges = torch.linspace(0, 1, 5, device=dev)
    ids = ops.group_hist_op(xs, edges)[0]
    rscale = torch.full((4,), 0.03, device=dev)
    enh = GroupEnhancers(4, device=dev)

    def step_fn(s, step):
        enh.load(s["params"])
        opt = {"step": int(s["n"]), "m": s["m"], "v": s["v"]}
        idx = torch.arange(step % 4 * 4, step % 4 * 4 + 4, device=dev)
        train_step(enh, opt, xs[idx], rs[idx], ids[idx], edges, rscale, 1e-3, n_groups=4,
                   residual_learning=True)
        return {"params": {k: p.detach().clone() for k, p in enh.params().items()},
                "m": opt["m"], "v": opt["v"], "n": torch.tensor(opt["step"], device=dev)}, {}

    def run(name, fail_at):
        opt = adamw.init(enh.params())
        start = {"params": {k: p.detach().clone() for k, p in
                            GroupEnhancers(4, device=dev).params().items()},
                 "m": opt["m"], "v": opt["v"], "n": torch.tensor(0, device=dev)}
        loop = ResilientLoop(step_fn, lambda step: step, CheckpointManager(tmp_path / name),
                             ckpt_every=5)
        return loop.run(start, 20, injector=FailureInjector(fail_at))

    cudnn = torch.backends.cudnn
    prev = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        a, _, r0 = run("clean", set())
        b, _, r1 = run("failed", {7, 13})
    finally:
        cudnn.deterministic, cudnn.benchmark = prev
    assert (r0, r1) == (0, 2) and int(b["n"]) == 20
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k])
        assert torch.equal(a["m"][k], b["m"][k]) and torch.equal(a["v"][k], b["v"][k])


def test_grad_compress_on_the_card_matches_the_cpu(cuda):
    """quantize_leaf on the card: the scale within 4 float32 ulps of the
    CPU's (the RMS reduction's order), codes equal but at half-integer
    ties, every code within the bound."""
    from repro_torch.optim import grad_compress as gc

    rng = np.random.default_rng(0)
    g = rng.normal(size=(32, 3, 3, 1, 9)).astype(np.float32)
    e = (rng.normal(size=g.shape) * 0.01).astype(np.float32)
    for dt in ("int8", "int16"):
        cfg = gc.GradCompressConfig(rel_eb=0.05, code_dtype=dt)
        cc, cs, _ = gc.quantize_leaf(torch.from_numpy(g), torch.from_numpy(e), cfg)
        dc, ds, de = gc.quantize_leaf(torch.from_numpy(g).to(cuda), torch.from_numpy(e).to(cuda),
                                      cfg)
        assert dc.device.type == "cuda" and dc.dtype == cc.dtype and de.dtype == torch.float32
        a, b = np.float32(cs).view(np.int32), np.float32(ds.cpu()).view(np.int32)
        assert abs(int(a) - int(b)) <= 4
        assert int((dc.cpu().to(torch.int32) - cc.to(torch.int32)).abs().max()) <= 1


def test_dist_gwlz_step_on_the_card_follows_the_cpu(cuda):
    """Two distributed GWLZ steps with gradient compression on the card from
    the CPU's initial state: losses within rtol 1e-4 (cuDNN against the CPU
    convolutions), one group_hist launch a step."""
    from repro_torch.core import grouping
    from repro_torch.core.enhancer import GroupEnhancers
    from repro_torch.data import nyx_like_field
    from repro_torch.launch import gwlz_dist

    x = nyx_like_field((16, 32, 32), "temperature", seed=0)
    cfg = gwlz_dist.DistGWLZConfig(n_groups=4, volume=32, batch_slices=8, grad_compress=True)
    batch = {"x": x[:8], "r": x[:8] * np.float32(1e-3),
             "edges": grouping.compute_edges(torch.from_numpy(x), 4),
             "rscale": np.full(4, np.abs(x).max() * 1e-3, np.float32)}
    losses = {}
    for dev in ("cpu", cuda):
        enh = GroupEnhancers(4, generator=torch.Generator().manual_seed(0), device=dev)
        state = gwlz_dist.build_state(cfg, enhancers=enh)
        step = gwlz_dist.make_dist_train_step(cfg, device=dev)
        ops.reset_launches()
        losses[str(dev)] = [step(state, batch)[1].cpu().numpy() for _ in range(2)]
        if dev != "cpu":
            assert ops.LAUNCHES["group_hist"] == 2
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4, atol=1e-9)


def test_lm_train_step_on_the_card_follows_the_cpu(cuda):
    """The reduced granite in float32 from the CPU's initial parameters:
    three steps with fp32 moments on the card within rtol 1e-4 of the
    CPU's losses, and three with int8 moments replayed bit for bit on the
    card (their stochastic rounding draws from the card's generator)."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import TrainOptions, make_train_step
    from repro_torch.launch.train import deterministic, make_loop_step, prng_key
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True), dtype="fp32")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 17)))
    init = DecoderLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    losses = {}
    with deterministic(cuda):
        for run, dev, moments in (("cpu", "cpu", "fp32"), ("cuda", cuda, "fp32"),
                                  ("int8", cuda, "int8"), ("int8_again", cuda, "int8")):
            model = DecoderLM(cfg, device=dev)
            params = tree.rebuild(init, lambda _, p: p.detach().clone().to(dev))
            step, adam_cfg = make_train_step(model, cfg, TrainOptions(
                lr=1e-3, warmup=1, total_steps=3, moment_dtype=moments))
            state = (params, adamw.init(params, adam_cfg), prng_key(1))
            loop_step = make_loop_step(step)
            batch = {"tokens": toks[:, :-1].to(dev), "targets": toks[:, 1:].to(dev)}
            out = []
            for _ in range(3):
                state, m = loop_step(state, batch)
                out.append(float(m["loss"]))
            losses[run] = out
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    assert losses["int8"] == losses["int8_again"]


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b", "qwen2-vl-7b", "whisper-small"])
def test_lm_family_on_the_card_follows_the_cpu(cuda, arch):
    """A reduced recurrent, hybrid, M-RoPE or encoder-decoder config in
    float32 from the CPU's parameters: 12 greedy decode steps' logits and
    one training loss and its gradients on the card within 1e-4 of the
    CPU's largest value."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import build_model
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_decode_step

    models = {dev: build_model(arch, reduced=True, device=dev) for dev in ("cpu", cuda)}
    cfg = dataclasses.replace(models["cpu"][1], dtype="fp32", remat=False)
    models = {dev: (type(m)(cfg, device=dev), cfg) for dev, (m, _) in models.items()}
    init = models["cpu"][0].init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab, (2, 17))
    feats = rng.normal(0, 1, (2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    got = {}
    for dev, (model, _) in models.items():
        params = tree.rebuild(init, lambda _, p: p.detach().clone().to(dev))
        with torch.no_grad():
            enc_out = (model.encode(params, torch.from_numpy(feats).to(dev))
                       if cfg.enc_layers else None)
            gen, logits = generate(make_decode_step(model), params, model.init_cache(
                2, 16, dtype=torch.float32), torch.from_numpy(prompt).to(dev), 9, enc_out)
        leaves = [p.requires_grad_(True) for _, p in tree.leaves(params)]
        t = torch.from_numpy(toks).to(dev)
        if cfg.enc_layers:
            loss, _ = model.loss(params, torch.from_numpy(feats).to(dev), t[:, :-1], t[:, 1:])
        else:
            pos = torch.arange(16, device=dev)
            if cfg.attn is not None and cfg.attn.mrope_sections is not None:
                pos = pos[None, None].expand(2, 3, 16)
            loss, _ = model.loss(params, t[:, :-1], t[:, 1:], pos)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        got[str(dev)] = (gen.cpu(), logits.cpu(), float(loss.detach()),
                         [None if g is None else g.cpu() for g in grads])
    (gen_a, lg_a, loss_a, g_a), (gen_b, lg_b, loss_b, g_b) = got.values()
    assert float((lg_b - lg_a).abs().max()) <= 1e-4 * float(lg_a.abs().max())
    assert abs(loss_b - loss_a) <= 1e-4 * abs(loss_a)
    for a, b in zip(g_a, g_b):
        assert (a is None) == (b is None)
        if a is not None:
            assert float((b - a).abs().max()) <= 1e-4 * (float(a.abs().max()) + 1e-30)


# the gwlz-write cell's training step: 64x64 slices, G = 20, C = 9, batch 10
CELL_TRAIN = dict(n_groups=20, channels=9, batch_size=10)


def _cell_slices(dev, seed: int, n: int = 120):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(n, 64, 64, generator=g, device=dev)
    return x, 0.01 * torch.randn(n, 64, 64, generator=g, device=dev)


@pytest.fixture
def deterministic_cudnn():
    cudnn = torch.backends.cudnn
    prev = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    yield
    cudnn.deterministic, cudnn.benchmark = prev


def test_captured_training_step_is_bit_equal_to_the_eager_step(cuda, deterministic_cudnn,
                                                                 monkeypatch):
    """train_enhancers' loop replays its captured step: every step's losses
    and the parameters, Adam moments and BN statistics after it equal, bit
    for bit, the eager step's from the same init on the same batches (24
    steps).  Twice in one process, on new tensors, so a graph that kept a
    stale address fails."""
    from repro_torch.core import trainer as PT
    from repro_torch.core.enhancer import GroupEnhancers
    from repro_torch.optim import adamw

    def state(enh, opt):
        return [t.detach().clone() for t in (*enh.params().values(), enh.mean, enh.var,
                                             *opt["m"].values(), *opt["v"].values())]

    real = PT.train_step
    cfg = PT.GWLZTrainConfig(**CELL_TRAIN, epochs=2)
    for seed in (1, 2):
        calls = []

        def recorded(enh, opt_state, xb, rb, idsb, edges, rscale, lr, **kw):
            args = (xb.clone(), rb.clone(), idsb.clone(), edges.clone(), rscale.clone(), lr)
            captured = PT._CAPTURED.get() is not None
            losses = real(enh, opt_state, xb, rb, idsb, edges, rscale, lr, **kw)
            calls.append((args, kw, captured, losses.clone(), state(enh, opt_state)))
            return losses

        monkeypatch.setattr(PT, "train_step", recorded)
        PT.train_enhancers(*_cell_slices(cuda, seed), cfg, device=cuda)
        monkeypatch.setattr(PT, "train_step", real)
        assert len(calls) == 24 and all(c[2] for c in calls)
        enh = GroupEnhancers(20, 9, device=cuda, generator=torch.Generator().manual_seed(0))
        opt = adamw.init(enh.params())
        for args, kw, _, losses, after in calls:  # outside the loop: the eager step
            assert torch.equal(PT.train_step(enh, opt, *args, **kw), losses)
            assert all(torch.equal(a, b) for a, b in zip(state(enh, opt), after))


def test_train_step_wrapper_sees_one_call_a_step_on_the_card(cuda, monkeypatch):
    """The benchmark probe's contract with the captured step: a wrapper of
    the module-level ``train_step`` sees one call a step, with
    ``opt_state["step"]`` the call's index (no call from the warm-up or the
    capture), and Adam's first moment moved once call 0 returns."""
    from repro_torch.core import trainer as PT

    real, steps, moved = PT.train_step, [], []

    def probed(enh, opt_state, *args, **kwargs):
        steps.append(int(opt_state["step"]))
        losses = real(enh, opt_state, *args, **kwargs)
        if len(steps) == 1:
            moved.append(all(bool(m.abs().sum() > 0) for k, m in opt_state["m"].items()
                             if k != "b1"))
        return losses

    monkeypatch.setattr(PT, "train_step", probed)
    PT.train_enhancers(*_cell_slices(cuda, 3), PT.GWLZTrainConfig(**CELL_TRAIN, epochs=1),
                       device=cuda)
    assert steps == list(range(12)) and moved == [True]
