"""Port parity: the chunked Huffman / zlib entropy stage.

The same numpy code arrays go through ``repro.sz.entropy`` and
``repro_torch.sz.entropy`` (CPU tensors, so the plain PyTorch versions of
the kernels run).  Codecs, blob bytes and decodes are compared bit for bit,
and the plain kernels are held against the reference's Pallas kernels in
interpret mode (one small case each) and its jnp path.
"""
import os
import struct
import subprocess
import sys
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as rops
from repro.sz import entropy as R
from repro_torch.kernels import ops, ref
from repro_torch.sz import entropy as P

BACKENDS = ("zlib", "huffman", "huffman+zlib")


def _cases():  # the cases of tests/test_entropy.py
    rng = np.random.default_rng(7)
    return {
        "skewed": rng.choice([0] * 8 + [1, -1, 2, -2, 9], size=60000).astype(np.int32),
        "uniform_wide": rng.integers(-600, 600, size=37777).astype(np.int32),
        "single_symbol": np.full(1234, -3, np.int32),
        "empty": np.zeros(0, np.int32),
        "one_element": np.array([5], np.int32),
        "big_magnitude": rng.integers(-(2**17), 2**17, size=4000).astype(np.int32),
        "extreme_magnitude": np.array([2**30, -(2**30), 0, 0, 7], np.int32),
    }


def _escape_codes(top: int = 14) -> np.ndarray:
    """An alphabet skewed past the 12-bit LUT: the escape path."""
    sizes = [2**i for i in range(top, 0, -1)] + [1, 1]
    codes = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    np.random.default_rng(0).shuffle(codes)
    return codes


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", list(_cases()))
def test_fit_matches_reference(name):
    codes = _cases()[name]
    a = P.HuffmanCodec.fit(_t(codes))
    b = R.HuffmanCodec.fit(codes, use_accel=False)
    np.testing.assert_array_equal(a.alphabet, b.alphabet)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_array_equal(a.codes, b.codes)
    assert a.table_bytes() == b.table_bytes()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(_cases()))
def test_blob_bytes_and_cross_decode(name, backend):
    codes = _cases()[name]
    port = P.encode_codes(_t(codes), backend)
    assert port == R.encode_codes(codes, backend, use_pallas=False)
    # the reference's blob decodes in the port and the port's in the reference
    np.testing.assert_array_equal(P.decode_codes(port, codes.shape, device="cpu").numpy(), codes)
    np.testing.assert_array_equal(R.decode_codes(port, codes.shape, use_pallas=False), codes)


@pytest.mark.parametrize("n", [0, 1, 7, 255, 256, 257, 1023, 1024, 1025])
def test_chunk_boundaries(n):
    codes = np.random.default_rng(n).integers(-9, 9, size=n).astype(np.int32)
    for cs in (8, 64, 256):
        for backend in ("huffman", "huffman+zlib"):
            port = P.encode_codes(_t(codes), backend, chunk_size=cs)
            assert port == R.encode_codes(codes, backend, chunk_size=cs, use_pallas=False)
            np.testing.assert_array_equal(
                P.decode_codes(port, codes.shape, device="cpu").numpy(), codes)


@pytest.mark.parametrize("case", ["escape", "deep_skew"])
def test_long_codes(case):
    """Codes longer than the 12-bit LUT take the binary-search escape."""
    if case == "escape":
        codes = _escape_codes()
    else:
        sizes = np.minimum([1, 1] + [2**i for i in range(1, 45)], 1024)
        codes = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
        np.random.default_rng(1).shuffle(codes)
    codec = P.HuffmanCodec.fit(_t(codes))
    assert int(codec.lengths.max()) > 12
    for backend in ("huffman", "huffman+zlib"):
        port = P.encode_codes(_t(codes), backend, chunk_size=64)
        assert port == R.encode_codes(codes, backend, chunk_size=64, use_pallas=False)
        np.testing.assert_array_equal(P.decode_codes(port, codes.shape, device="cpu").numpy(), codes)


def test_max_codeword_window_decodes():
    """A table whose longest code is 32 bits, with that code (all ones) last
    in the stream: the escape window at the top of the code space must stop
    at the last codeword (the reference's mid <= n-1 clamp)."""
    fib = np.asarray([1, 1] + [2**i for i in range(1, 45)], np.int64)
    L = P._limited_code_lengths(fib)
    assert int(L.max()) == 32
    alphabet = np.arange(L.size, dtype=np.int32)
    codec = P.HuffmanCodec(alphabet, L, P._canonical_codes(L))
    sym = np.concatenate([np.arange(L.size), [np.argmax(L)]]).astype(np.int32)
    rcodec = R.HuffmanCodec(alphabet, L, R._canonical_codes(L))
    stream, chunk_bits, total = _host_pack(rcodec, sym, 8)
    got = codec.decode_chunked_device(stream, sym.size, 8, chunk_bits,
                                      total_bits=total, device=torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), sym)
    # the reference's host decode agrees on the same stream
    np.testing.assert_array_equal(
        rcodec.decode_chunked(stream, sym.size, 8, chunk_bits, total_bits=total), sym)


def test_fuzz_parity():
    rng = np.random.default_rng(99)
    for _ in range(10):
        n = int(rng.integers(1, 3000))
        alpha = int(rng.integers(1, 200))
        base = int(rng.integers(-(2**16), 2**16))
        p = rng.dirichlet(np.full(alpha, float(rng.uniform(0.05, 2.0))))
        codes = (base + rng.choice(alpha, size=n, p=p)).astype(np.int32)
        cs = int(rng.choice([8, 32, 256]))
        for backend in BACKENDS:
            port = P.encode_codes(_t(codes), backend, chunk_size=cs)
            assert port == R.encode_codes(codes, backend, chunk_size=cs, use_pallas=False)
            np.testing.assert_array_equal(
                P.decode_codes(port, codes.shape, device="cpu").numpy(), codes)


@pytest.mark.parametrize("span_bits", [23, 28, 31])
def test_wide_span_fit_matches_reference(span_bits):
    """A sparse alphabet wider than the dense histogram's 2**22 bins is
    counted by torch.unique on the tensor's own device, where the reference
    takes np.unique: same codec, same blob."""
    rng = np.random.default_rng(span_bits)
    values = rng.integers(-(2 ** (span_bits - 1)), 2 ** (span_bits - 1), 40)
    values[:2] = [-(2 ** (span_bits - 1)), 2 ** (span_bits - 1) - 1]
    codes = values[rng.zipf(1.6, 5000) % values.size].astype(np.int32)
    codec = P.HuffmanCodec.fit(_t(codes))
    rcodec = R.HuffmanCodec.fit(codes, use_accel=False)
    np.testing.assert_array_equal(codec.alphabet, rcodec.alphabet)
    np.testing.assert_array_equal(codec.lengths, rcodec.lengths)
    port = P.encode_codes(_t(codes), "huffman+zlib")
    assert port == R.encode_codes(codes, "huffman+zlib", use_pallas=False)
    np.testing.assert_array_equal(P.decode_codes(port, codes.shape, device="cpu").numpy(), codes)


# -- plain kernels against the reference's Pallas kernels / jnp path ------------


def test_symbol_hist_plain_matches_pallas():
    rng = np.random.default_rng(3)
    s = rng.integers(-5, 70, size=3000).astype(np.int32)  # includes out-of-range
    got = ref.symbol_hist_ref(_t(s), 64).numpy()
    pallas = rops.symbol_hist_op(jnp.asarray(s), n_bins=64, use_pallas=True, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    big = rng.integers(0, 5000, size=20000).astype(np.int32)
    np.testing.assert_array_equal(
        ref.symbol_hist_ref(_t(big), 5000).numpy(),
        np.asarray(rops.symbol_hist_op(jnp.asarray(big), n_bins=5000, use_pallas=False)))


def _pack_inputs(codes: np.ndarray, cs: int):
    codec = P.HuffmanCodec.fit(_t(codes))
    lens, cws = codec._pack_inputs(_t(codes), cs)
    return codec, lens, cws


@pytest.mark.parametrize("case", ["pallas", "jnp_escape", "jnp_short_chunk"])
def test_huffman_encode_plain_matches_reference(case):
    rng = np.random.default_rng(4)
    if case == "pallas":
        codes, cs = rng.choice([0, 0, 0, 1, -1, 5], size=300).astype(np.int32), 64
    elif case == "jnp_escape":
        codes, cs = _escape_codes(), 256
    else:
        codes, cs = rng.integers(-40, 40, size=1001).astype(np.int32), 256
    _, lens, cws = _pack_inputs(codes, cs)
    words, bits = ref.huffman_encode_ref(lens, cws)
    args = (jnp.asarray(lens.numpy()), jnp.asarray(cws.numpy()))
    w_ref, b_ref = rops.huffman_encode_op(*args, use_pallas=case == "pallas", interpret=True)
    np.testing.assert_array_equal(words.numpy(), np.asarray(w_ref))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(b_ref))


@pytest.mark.parametrize("case", ["pallas", "jnp_escape", "jnp_short_chunk"])
def test_huffman_decode_plain_matches_reference(case):
    rng = np.random.default_rng(6)
    if case == "pallas":
        codes, cs = rng.choice([0, 0, 0, 1, -1, 5, 30], size=200).astype(np.int32), 64
    elif case == "jnp_escape":
        codes, cs = _escape_codes(13), 256
    else:
        codes, cs = rng.integers(-40, 40, size=1001).astype(np.int32), 256
    blob = P.encode_codes(_t(codes), "huffman", chunk_size=cs)
    codec, n, cs, chunk_bits, stream, _ = P.parse_chunked(blob)
    cb = np.asarray(chunk_bits, np.int64)
    args, kw = codec._decode_inputs(stream, n, cs, np.cumsum(cb) - cb, torch.device("cpu"))
    # the decode takes int64 bit offsets (entropy's own) and int32 ones (the
    # reference's); the plain version and the op give the reference's ids
    # for both.  The reference's op takes the LUT split into int32 tables.
    args32 = (args[0], args[1].to(torch.int32), *args[2:])
    split = _split_lut(args[3].numpy(), args[5].shape[0])
    jargs = (*args32[:3], *split, *args32[4:])
    want = rops.huffman_decode_op(*(jnp.asarray(np.asarray(a)) for a in jargs), **kw,
                                  use_pallas=case == "pallas", interpret=True)
    for a in (args, args32):
        got = ref.huffman_decode_ref(*a, **kw).numpy()
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(ops.huffman_decode_op(*a, **kw).numpy(), got)
    np.testing.assert_array_equal(codec.alphabet[got.reshape(-1)[:n]], codes)


def _split_lut(lut: np.ndarray, n_symbols: int):
    """The packed LUT read with the decode's shifts, as the reference's split
    int32 tables: (count, consumed bits, ids [S, 2**k])."""
    from repro_torch.kernels.huffman_decode import lut_layout

    B, S, id_base = lut_layout(n_symbols)
    e = lut.view(np.uint64)
    mask = np.uint64((1 << B) - 1)
    ids = np.stack([(e >> np.uint64(id_base + j * B)) & mask for j in range(S)])
    return ((e & np.uint64(0xFF)).astype(np.int32),
            ((e >> np.uint64(8)) & np.uint64(0xFF)).astype(np.int32), ids.astype(np.int32))


def _host_pack(rcodec, sym: np.ndarray, cs: int):
    """Pack ``sym`` with the reference's host bit packer (any code length):
    (stream bytes, chunk_bits, total bits)."""
    stream, ends, total = rcodec._encode_bits(sym)
    n_chunks = -(-sym.size // cs)
    bnd = np.minimum(np.arange(1, n_chunks + 1) * cs, sym.size) - 1
    return stream.tobytes(), np.diff(np.concatenate([[0], ends[bnd]])), total


def _hc_blob(rcodec, sym: np.ndarray, cs: int) -> bytes:
    """Frame an ``hc`` blob around a stream packed on the host by ``rcodec``
    (which may hold codes longer than the encoder would ever emit)."""
    import struct

    stream, chunk_bits, total = _host_pack(rcodec, sym, cs)
    table = rcodec.table_bytes()
    return (b"RPREhc" + struct.pack("<QIII", sym.size, cs, chunk_bits.size, len(table))
            + table
            + struct.pack("<Q", total)
            + chunk_bits.astype(P._chunk_bits_dtype(cs)).tobytes() + stream)


def test_oversize_chunk_reference_blob_decodes():
    """A reference blob whose chunks are larger than the encode kernel's
    shared memory still decodes: the decode kernel has no such limit."""
    codes = np.random.default_rng(8).integers(-30, 30, 20000).astype(np.int32)
    cs = P.MAX_CHUNK + 1
    blob = R.encode_codes(codes, "huffman+zlib", chunk_size=cs, use_pallas=False)
    np.testing.assert_array_equal(P.decode_codes(blob, codes.shape, device="cpu").numpy(),
                                  codes)


@pytest.mark.parametrize("case", ["oversize_chunk", "overlong_code"])
def test_unsupported_streams_are_refused(case):
    """What the kernels cannot take is refused on every device, never moved
    to a host path: an encode chunk past the kernel's shared memory, and a
    table with 40-bit codes (no encoder writes one; the reference's host bit
    walk still reads it)."""
    if case == "oversize_chunk":
        codes = np.random.default_rng(8).integers(-30, 30, 20000).astype(np.int32)
        with pytest.raises(ValueError, match="chunk size"):
            P.encode_codes(_t(codes), "huffman+zlib", chunk_size=P.MAX_CHUNK + 1)
        return
    L = P._limited_code_lengths(np.asarray([1, 1] + [2**i for i in range(1, 50)]), 40)
    assert int(L.max()) > 32
    alphabet = np.arange(L.size, dtype=np.int32) - 7
    rcodec = R.HuffmanCodec(alphabet, L, R._canonical_codes(L))
    sym = np.concatenate([alphabet, alphabet[::-1], [alphabet[np.argmax(L)]]])
    blob = _hc_blob(rcodec, sym, 16)
    np.testing.assert_array_equal(R.decode_codes(blob, sym.shape, use_pallas=False), sym)
    with pytest.raises(ValueError, match="corrupt Huffman table"):
        P.decode_codes(blob, sym.shape, device="cpu")


def test_decode_inputs_hand_the_kernel_int64_offsets():
    """Bit offsets travel as int64, so a stream may run past 2**31 bits;
    only a chunk's own bits are held below 2**31."""
    codes, cs = np.random.default_rng(6).integers(-40, 40, size=1001).astype(np.int32), 256
    codec = P.HuffmanCodec.fit(_t(codes))
    offsets = np.array([0, 2**31 + 5, 2**32 + 77, 5 * 2**32], np.int64)
    args, kw = codec._decode_inputs(b"\x00" * 64, 4 * cs, cs, offsets, torch.device("cpu"))
    assert args[1].dtype == torch.int64 and args[1].tolist() == offsets.tolist()
    assert args[2].dtype == torch.int32
    tabs = codec._tables_on(torch.device("cpu"))
    assert all(a is b for a, b in zip(args[3:], tabs[:4]))
    assert kw == {"chunk_size": cs, "k": tabs.k}


@pytest.mark.parametrize("span", [40, 1000, 100000])
def test_decode_tables_are_the_references(span):
    """One table value a codec and device: the packed LUT, read with the
    decode's shifts, and the escape tables equal the reference codec's own
    device tables for the same codes (6 x 8-bit, 3 x 16-bit and 1 x 32-bit
    id slots), and the device copy holds exactly the packed LUT, ``cw_map``,
    ``order``, ``len_sorted`` and the alphabet."""
    codes = np.random.default_rng(span).integers(-span, span, max(50000, 2 * span))
    codes = codes.astype(np.int32)
    codec = P.HuffmanCodec.fit(_t(codes))
    want = R.HuffmanCodec.fit(codes, use_accel=False)._device_tables()
    tabs = codec._tables_on(torch.device("cpu"))
    assert tabs._fields == ("lut", "cw_map", "order", "len_sorted", "alphabet", "k")
    assert [t.dtype for t in tabs[:5]] == [torch.int64] + [torch.int32] * 4
    assert tabs.k == want["k"] and tabs.lut.shape == (1 << tabs.k,)
    split = _split_lut(tabs.lut.numpy(), codec.alphabet.size)
    assert split[2].shape[0] == {40: 6, 1000: 3, 100000: 1}[span]
    for name, got in zip(("lut_count", "lut_bits", "lut_ids"), split):
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    for name in ("cw_map", "order", "len_sorted"):
        np.testing.assert_array_equal(getattr(tabs, name).numpy(), want[name], err_msg=name)
    np.testing.assert_array_equal(tabs.alphabet.numpy(), codec.alphabet)
    assert codec._tables_on("cpu") is tabs


INT32_MIN = np.array([-(2**31), 5, -7], np.int32)


def test_zlib_keeps_a_code_of_int32_min():
    """A lane holding -2**31 is written as ``z4``: it round-trips in the port
    and opens correctly in the reference."""
    blob = P.encode_codes(_t(INT32_MIN), "zlib")
    assert blob[4:6] == b"z4"
    np.testing.assert_array_equal(P.decode_codes(blob, (3,), device="cpu").numpy(), INT32_MIN)
    np.testing.assert_array_equal(np.asarray(R.decode_codes(blob, (3,))), INT32_MIN)


def test_reference_z2_of_int32_min_decodes_to_zero():
    """A record of the reference's behaviour (ROADMAP Queue 3): its abs test
    wraps at -2**31, so it writes ``z2`` and both packages read the code as
    0.  The port no longer writes these bytes."""
    blob = R.encode_codes(INT32_MIN, "zlib")
    assert blob[4:6] == b"z2"
    want = [0, 5, -7]
    np.testing.assert_array_equal(P.decode_codes(blob, (3,), device="cpu").numpy(), want)
    np.testing.assert_array_equal(np.asarray(R.decode_codes(blob, (3,))), want)
    assert P.encode_codes(_t(INT32_MIN), "zlib") != blob


@pytest.mark.parametrize("lane", [
    [0, 1, -1, 3], [2**15 - 1, -(2**15 - 1), 0], [-(2**15), 4], [2**15, -3],
    [-(2**31) + 1, 2], [2**31 - 1, 0],
], ids=["small", "int16_limits", "minus_2^15", "plus_2^15", "int32_min_plus_1", "int32_max"])
def test_zlib_tag_and_bytes_equal_the_reference(lane):
    """Without -2**31 the port's z2 test agrees with the reference's: the
    same tag and the same bytes."""
    a = np.array(lane, np.int32)
    blob = P.encode_codes(_t(a), "zlib")
    assert blob == R.encode_codes(a, "zlib")
    assert blob[4:6] == (b"z2" if np.abs(a.astype(np.int64)).max() < 2**15 else b"z4")


# ---------------------------------------------------------------------------
# the read leftovers: shannon_bits, legacy hf/hz blobs, range decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["dense", "one_symbol", "int64_pair", "sparse_span",
                                  "float", "empty"])
def test_shannon_bits_matches_reference(case):
    rng = np.random.default_rng(31)
    x = {"dense": rng.integers(-500, 500, size=20000).astype(np.int32),
         "one_symbol": np.full(100, 7, np.int32),
         "int64_pair": rng.choice([0, 1], size=64).astype(np.int64),
         "sparse_span": np.array([-(2**40), 0, 2**40, 2**40], np.int64),
         "float": rng.normal(size=3000),
         "empty": np.zeros(0, np.int32)}[case]
    want = R.shannon_bits(x)
    assert P.shannon_bits(_t(x)) == pytest.approx(want, rel=1e-12)
    assert P.shannon_bits(x) == pytest.approx(want, rel=1e-12)


def _legacy_cases():
    cases = {k: v for k, v in _cases().items() if k != "big_magnitude"}
    rng = np.random.default_rng(3)
    cases["seed_test"] = rng.choice([0, 0, 0, 1, -2], size=5000).astype(np.int32)
    cases["escape"] = _escape_codes(18)
    cases["ten_of_one"] = np.full(10, 4, np.int32)
    return cases


@pytest.mark.parametrize("backend", ["huffman", "huffman+zlib"])
@pytest.mark.parametrize("name", list(_legacy_cases()))
def test_legacy_bytes_and_cross_decode(name, backend):
    """``encode_codes_legacy`` bytes equal the reference's; each package
    decodes the other's hf/hz blob bit for bit (the escape case has codes
    past the 12-bit LUT; empty has n_symbols == 0)."""
    codes = _legacy_cases()[name]
    port = P.encode_codes_legacy(_t(codes), backend)
    assert port[4:6] == (b"hf" if backend == "huffman" else b"hz")
    assert port == R.encode_codes_legacy(codes, backend)
    np.testing.assert_array_equal(P.decode_codes(port, codes.shape, device="cpu").numpy(), codes)
    np.testing.assert_array_equal(R.decode_codes(port, codes.shape), codes)
    with pytest.raises(ValueError, match="huffman backends"):
        P.encode_codes_legacy(_t(codes), "zlib")


@pytest.mark.parametrize("n", [1, 255, 256, 257, 2000])
def test_legacy_bounds_plain_version_against_bitwalk(n):
    """The boundary pass's plain version gives each chunk's start bit as the
    reference encoder's per-symbol bit ends place it, and the decode from
    those bounds equals the reference's ``decode_bitwalk``."""
    codes = _escape_codes(13)[:n]
    rcodec = R.HuffmanCodec.fit(codes, use_accel=False)
    _packed, ends, total = rcodec._encode_bits(codes)
    stream = rcodec.encode(codes)
    codec = P.HuffmanCodec.fit(_t(codes))
    tabs = codec._tables_on(torch.device("cpu"))
    words = P._stream_words(stream[8:], 0, None, "cpu")
    cs = P.DEFAULT_CHUNK
    got = ops.huffman_legacy_bounds_op(words, tabs.cw_map, tabs.len_sorted,
                                       n_symbols=n, chunk_size=cs).numpy()
    want = np.concatenate([[0], ends[cs - 1 : n - 1 : cs], [total]])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(codec.decode_bitwalk(stream, n, device="cpu").numpy(),
                                  rcodec.decode_bitwalk(stream, n))


def test_legacy_stream_that_ends_off_its_bit_count_is_refused():
    codes = _escape_codes(10)
    blob = bytearray(P.encode_codes_legacy(_t(codes), "huffman"))
    n, tlen = struct.unpack_from("<QI", blob, 6)
    struct.pack_into("<Q", blob, 18 + tlen, struct.unpack_from("<Q", blob, 18 + tlen)[0] - 1)
    with pytest.raises(ValueError, match="ends its"):
        P.decode_codes(bytes(blob), codes.shape, device="cpu")


@pytest.mark.parametrize("backend", ["huffman", "huffman+zlib", "zlib", "legacy"])
def test_decode_codes_range_is_the_slice(backend):
    """``decode_codes_range`` equals the full decode's slice bit for bit on
    chunk edges, single symbols and empty ranges, and agrees with the
    reference's; a range outside [0, n) raises ValueError in both."""
    codes = np.random.default_rng(17).choice([0] * 6 + list(range(-20, 20)),
                                              size=5000).astype(np.int32)
    n = codes.size
    blob = (P.encode_codes_legacy(_t(codes), "huffman+zlib") if backend == "legacy"
            else P.encode_codes(_t(codes), backend, chunk_size=64))
    full = P.decode_codes(blob, (n,), device="cpu")
    for lo, hi in [(0, n), (0, 0), (n, n), (64, 64), (0, 64), (64, 128), (63, 65),
                   (100, 101), (n - 1, n), (1000, 4321), (n - 64, n)]:
        got = P.decode_codes_range(blob, lo, hi, device="cpu")
        assert got.dtype == torch.int32
        assert torch.equal(got, full[lo:hi]), (lo, hi)
        np.testing.assert_array_equal(got.numpy(), R.decode_codes_range(blob, lo, hi))
    for lo, hi in [(0, n + 1), (-1, 3), (10, 9)]:
        with pytest.raises(ValueError):
            P.decode_codes_range(blob, lo, hi, device="cpu")
        with pytest.raises(ValueError):
            R.decode_codes_range(blob, lo, hi)


def test_range_decode_uploads_only_its_chunks(monkeypatch):
    """On hc/hZ a range decodes only the chunks that cover it: the decode
    op sees those chunks' offsets and counts and only their words."""
    codes = np.random.default_rng(2).integers(-30, 30, size=4096).astype(np.int32)
    blob = P.encode_codes(_t(codes), "huffman", chunk_size=64)
    seen = []
    real = ops.huffman_decode_op

    def spy(words, offsets, counts, *a, **kw):
        seen.append((words.numel(), offsets.tolist(), counts.tolist()))
        return real(words, offsets, counts, *a, **kw)

    monkeypatch.setattr(ops, "huffman_decode_op", spy)
    got = P.decode_codes_range(blob, 130, 250, device="cpu")
    np.testing.assert_array_equal(got.numpy(), codes[130:250])
    (n_words, offsets, counts), = seen
    assert len(offsets) == 2 and counts == [64, 64]  # chunks 2 and 3
    assert n_words * 32 < sum(P.parse_chunked(blob)[3]) / 4


# --- the lanes' framing and zlib on the process's host threads ---


class _CountingPool(ThreadPoolExecutor):
    """A pool that counts the work handed to it."""

    def __init__(self, workers: int):
        super().__init__(workers, thread_name_prefix="test-deflate")
        self.submitted = 0

    def submit(self, fn, *args, **kwargs):
        self.submitted += 1
        return super().submit(fn, *args, **kwargs)


@pytest.fixture
def pool_of(monkeypatch):
    """Put a counting pool of ``workers`` threads in the module's place."""
    made = []

    def install(workers: int) -> _CountingPool:
        made.append(_CountingPool(workers))
        monkeypatch.setattr(P, "_POOL", (os.getpid(), workers, made[-1]))
        return made[-1]

    yield install
    for pool in made:
        pool.shutdown(wait=True)


def _lanes(case: str) -> np.ndarray:
    rng = np.random.default_rng(31)
    if case == "mixed":  # lanes 1 and 3 span more than _LANES_SPAN
        lanes = np.rint(rng.laplace(0, 3, size=(5, 3000))).astype(np.int32)
        lanes[1, ::7] = rng.integers(-(2**17), 2**17, size=lanes[1, ::7].size)
        lanes[3, :2] = (-(2**20), 2**20)
        return lanes
    return np.rint(rng.laplace(0, 3, size=(int(case), 4096))).astype(np.int32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["1", "2", "33", "mixed"])
def test_pooled_lanes_are_the_serial_bytes(pool_of, case, backend):
    """``encode_codes_lanes`` with the pool engaged gives, lane for lane and
    byte for byte, the blobs of the pool held to one worker (the serial
    path, which hands the pool nothing) and of one ``encode_codes`` a lane;
    a one-lane call never engages the pool."""
    lanes = _lanes(case)
    if case == "mixed":
        span = lanes.max(axis=1).astype(np.int64) - lanes.min(axis=1) + 1
        assert list(span > P._LANES_SPAN) == [False, True, False, True, False]
    one = pool_of(1)
    serial = P.encode_codes_lanes(_t(lanes), backend)
    assert one.submitted == 0
    many = pool_of(4)
    pooled = P.encode_codes_lanes(_t(lanes), backend)
    assert many.submitted == (len(lanes) if len(lanes) >= 2 else 0)
    assert pooled == serial == [P.encode_codes(_t(lane), backend) for lane in lanes]
    for lane, blob in zip(lanes, pooled):
        np.testing.assert_array_equal(P.decode_codes(blob, lane.shape, device="cpu").numpy(),
                                      lane)


def test_a_failed_lane_reaches_the_caller_and_the_pool_stays_usable(pool_of, monkeypatch):
    """zlib raising on one lane raises in the caller after every lane's
    work has ended; the next call on the same pool gives the serial bytes."""
    lanes = _lanes("33")
    want = [P.encode_codes(_t(lane)) for lane in lanes]
    pool_of(4)
    real = zlib.compress
    lock = threading.Lock()
    seen = {"calls": 0, "running": 0}

    def flaky(data, level=-1):
        with lock:
            seen["calls"] += 1
            seen["running"] += 1
            k = seen["calls"]
        try:
            time.sleep(0.002)
            if k == 5:
                raise zlib.error("lane 5 refused")
            return real(data, level)
        finally:
            with lock:
                seen["running"] -= 1

    monkeypatch.setattr(P.zlib, "compress", flaky)
    with pytest.raises(zlib.error, match="lane 5 refused"):
        P.encode_codes_lanes(_t(lanes))
    assert seen["running"] == 0  # no lane's zlib outlived the call
    assert P.encode_codes_lanes(_t(lanes)) == want


def test_concurrent_callers_share_one_pool(monkeypatch):
    """More callers than cores, from a process with no pool yet, under a
    short switch interval: they make one pool between them, and each gets
    its own lanes' bytes in order."""
    monkeypatch.setattr(P, "_POOL", None)
    inputs = [np.rint(np.random.default_rng(k).laplace(0, 2 + k, size=(6, 2048))).astype(np.int32)
              for k in range(P._usable_cores() + 2)]
    want = [[P.encode_codes(_t(lane)) for lane in lanes] for lanes in inputs]
    got, pools = [None] * len(inputs), set()
    start = threading.Barrier(len(inputs))

    def caller(k):
        start.wait()
        pools.add(id(P._deflate_pool()[0]))  # all at once: the pool's making races
        got[k] = P.encode_codes_lanes(_t(inputs[k]))
        pools.add(id(P._POOL[2]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=caller, args=(k,)) for k in range(len(inputs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        P._POOL[2].shutdown(wait=True)
    assert not any(t.is_alive() for t in threads)
    assert len(pools) == 1 and got == want


_FORK_CHILD = """
import faulthandler, os, sys
import numpy as np, torch
torch.set_num_threads(1)  # torch's own OpenMP workers do not survive a fork
from repro_torch.sz import entropy as P
lanes = torch.from_numpy(np.random.default_rng(5).integers(-9, 9, size=(2, 3000), dtype=np.int32))
want = P.encode_codes_lanes(lanes)  # the parent uses the pool
assert P._POOL is not None and P._POOL[0] == os.getpid()
pid = os.fork()
if pid == 0:  # the child: leave by os._exit alone
    faulthandler.dump_traceback_later(60, exit=True)  # a hang prints where it waits
    code = 3
    try:
        code = 0 if P.encode_codes_lanes(lanes) == want else 1
    finally:
        os._exit(code)
_, status = os.waitpid(pid, 0)
sys.exit(os.waitstatus_to_exitcode(status))
"""


@pytest.mark.skipif(not hasattr(os, "fork"), reason="os.fork is POSIX only")
def test_a_forked_child_makes_its_own_pool():
    """After the parent used the pool, a child made by ``os.fork`` (which
    inherits none of its threads) encodes 2 lanes and exits 0, within a
    time limit.  In a process of its own, which imports no JAX and keeps
    torch to one thread: forking a process with JAX's or OpenMP's threads
    alive is unsafe whatever the pool does."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    got = subprocess.run([sys.executable, "-c", _FORK_CHILD], env=env, capture_output=True,
                         text=True, timeout=120)
    assert got.returncode == 0, got.stderr[-2000:]
