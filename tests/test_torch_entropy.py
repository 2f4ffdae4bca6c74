"""Port parity: the chunked Huffman / zlib entropy stage.

The same numpy code arrays go through ``repro.sz.entropy`` and
``repro_torch.sz.entropy`` (CPU tensors, so the plain PyTorch versions of
the kernels run).  Codecs, blob bytes and decodes are compared bit for bit,
and the plain kernels are held against the reference's Pallas kernels in
interpret mode (one small case each) and its jnp path.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as rops
from repro.sz import entropy as R
from repro_torch.kernels import ref
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
    got = ref.huffman_decode_ref(*args, **kw).numpy()
    want = rops.huffman_decode_op(*(jnp.asarray(a.numpy()) for a in args), **kw,
                                  use_pallas=case == "pallas", interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(codec.alphabet[got.reshape(-1)[:n]], codes)


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
