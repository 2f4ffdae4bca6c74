#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs nvcc and a CUDA card

Phases (any failure raises and the script exits non-zero):

1. build   -- compile the four CUDA kernels from ``src/repro_torch/csrc``
              (one nvcc per source, all at once) and time it;
2. edges   -- each kernel against its plain PyTorch version on the card,
              bit for bit (tolerance 0), on edge cases: .5 ties, negatives,
              |q| near 2**25, ragged tiles and ranks 1-2, spans above 4096,
              short last chunks, codes longer than the 12-bit LUT up to the
              32-bit maximum codeword;
3. main    -- the main path at full size: nyx_like_field((512,)*3,
              "temperature", seed=0), tile 64^3, rel_eb 1e-3, huffman+zlib,
              through compress_tiled -> to_bytes -> from_bytes ->
              decompress_tiled and decompress_region; launch counters are
              zeroed just before and read just after;
4. kernels -- each kernel again at the main path's shapes: bit-exact
              against its plain version, then timed (see ``kernel_ms`` and
              ``events_ms``) beside the plain version, a library call where
              one exists, and the bound (least time for the bytes it must
              move at 3.35 TB/s);
5. cpu     -- the 128^3 corner compressed on the card and on the CPU gives
              identical GWTC bytes;
6. golden  -- tests/golden/gwtc_v1.bin decodes on the card bit for bit.

Each phase prints a JSON line.  Then come the ``kernels`` line, the card's
name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM non-tensor float32 / int32 rate
SHAPE, TILE, REL_EB, BACKEND = (512, 512, 512), (64, 64, 64), 1e-3, "huffman+zlib"
ROI = ((100, 228), (37, 101), (300, 364))
KERNELS = {  # counter name -> (source, TPU kernel it replaces, __global__ name prefix)
    "lorenzo_quant_tiles": ("src/repro_torch/csrc/lorenzo_quant.cu",
                            "src/repro/kernels/lorenzo_quant.py:87",
                            "lorenzo_quant_tiles_kernel"),
    "symbol_hist": ("src/repro_torch/csrc/symbol_hist.cu",
                    "src/repro/kernels/group_hist.py:53", "symbol_hist_"),
    "huffman_encode": ("src/repro_torch/csrc/huffman_encode.cu",
                       "src/repro/kernels/huffman_encode.py:72",
                       "huffman_encode_pack_kernel"),
    "huffman_decode": ("src/repro_torch/csrc/huffman_decode.cu",
                       "src/repro/kernels/huffman_decode.py:106",
                       "huffman_decode_probe_kernel"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs_err(a, b) -> int:
    """Largest integer difference of two int32 results (0 = bit-exact)."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def events_ms(fn, reps: int) -> float:
    """Time of one call: CUDA events around ``reps`` back-to-back calls, over
    ``reps``.  The calls are queued behind a device-side sleep longer than
    their enqueue, so the host's launch cost is hidden unless a call
    synchronizes inside (then its host time counts, as its caller pays it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1.5 * enqueue_s * 2e9))  # cycles; the clock is <= 2 GHz
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_ms(fn, kernel: str, reps: int) -> tuple[float, str]:
    """Device time of the kernel alone: its own intervals in a torch.profiler
    trace of ``reps`` calls, over its launch count, so the wrapper's host
    work and output allocation are left out.  Where the profiler records no
    device time it falls back to :func:`events_ms`.  Returns (ms, method)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key
            and e.self_device_time_total > 0]
    count = sum(e.count for e in hits)
    if count == 0:
        return events_ms(fn, reps), "events"
    check(count == reps, f"profiler saw {count} launches of {kernel}, not {reps}")
    return sum(e.self_device_time_total for e in hits) / count / 1e3, "profiler"


class Parity:
    """Runs kernel-vs-plain comparisons and keeps each kernel's worst error."""

    def __init__(self):
        self.err = {name: 0 for name in KERNELS}
        self.cases = {name: 0 for name in KERNELS}

    def compare(self, name: str, case: str, got, want) -> None:
        import torch

        torch.cuda.synchronize()  # a fault during the kernel surfaces here
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        err = max(max_abs_err(g, w) for g, w in pairs)
        self.err[name] = max(self.err[name], err)
        self.cases[name] += 1
        check(err == 0, f"{name} [{case}] differs from its plain version by {err}")


def edge_parity(par: Parity) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import group_hist, huffman_decode, huffman_encode, ref
    from repro_torch.kernels import lorenzo_quant
    from repro_torch.sz import entropy

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # lorenzo: ties, negatives, |q| near 2**25, ragged tiles, ranks 1-3
    eb = 0.75
    two = float(np.float32(eb) * 2)
    ties = ((rng.integers(-4000, 4000, (3, 5, 13, 37)) + 0.5) * two).astype(np.float32)
    cases = {
        "ties_negatives_ragged": ties,
        "q_near_2^25": (rng.uniform(-1, 1, (2, 9, 40, 33)) * 2**25 * two).astype(np.float32),
        "rank1": rng.normal(0, 50, (4, 70)).astype(np.float32),
        "rank2": rng.normal(0, 50, (4, 17, 45)).astype(np.float32),
        "tile_64^3": rng.normal(0, 100, (3, 64, 64, 64)).astype(np.float32),
    }
    for case, x in cases.items():
        xt = torch.from_numpy(x).to(dev)
        par.compare("lorenzo_quant_tiles", case, lorenzo_quant.lorenzo_quant_tiles(xt, eb),
                    ref.lorenzo_quant_tiles_ref(xt, eb))

    # symbol_hist: shared-memory bins, a span above 4096, global-atomic bins,
    # out-of-range values
    for case, (lo, hi, bins, n) in {
        "span_300": (0, 300, 300, 262144),
        "span_5000_out_of_range": (-50, 5100, 5000, 100003),
        "span_200000_global": (0, 200000, 200000, 300001),
    }.items():
        s = torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32)).to(dev)
        par.compare("symbol_hist", case, group_hist.symbol_hist(s, bins),
                    ref.symbol_hist_ref(s, bins))

    # Huffman: codes longer than the 12-bit LUT (escape path) and a skew that
    # hits the 32-bit length cap; short last chunks; chunk sizes 8..1000
    sizes_esc = [2 ** i for i in range(16, 0, -1)] + [1, 1]
    fib = [1, 1] + [2 ** i for i in range(1, 45)]
    for case, (sizes, cs) in {
        "escape_cs256": (sizes_esc, 256),
        "max_codeword_cs64": (fib, 64),
        "escape_cs1000": (sizes_esc, 1000),
        "short_chunk_cs8": ([5, 3, 1], 8),
    }.items():
        counts = np.minimum(np.asarray(sizes, np.int64), 4096)  # keep the stream small
        sym = np.repeat(np.arange(len(sizes), dtype=np.int32), counts)
        rng.shuffle(sym)
        # put the longest code (the last symbol) at the very end too
        sym = np.concatenate([sym, [len(sizes) - 1]]).astype(np.int32)
        flat = torch.from_numpy(sym).to(dev)
        codec = entropy.HuffmanCodec.fit(flat)
        if case == "max_codeword_cs64":  # lengths of the uncapped skew: up to 32 bits
            L = entropy._limited_code_lengths(np.asarray(sizes, np.int64))
            codec = entropy.HuffmanCodec(codec.alphabet, L, entropy._canonical_codes(L))
            check(int(L.max()) == 32, "max-codeword case needs 32-bit codes")
        lens, cws = codec._pack_inputs(flat, cs)
        words, bits = huffman_encode.huffman_encode_pack(lens, cws)
        par.compare("huffman_encode", case, (words, bits), ref.huffman_encode_ref(lens, cws))
        local = words[:, : -(-int(bits.max()) // 32)].contiguous().cpu().numpy().view(np.uint32)
        bits64 = bits.cpu().numpy().astype(np.int64)
        stream, _ = entropy._splice_chunks(local, bits64)
        args, kw = codec._decode_inputs(stream, sym.size, cs,
                                        np.cumsum(bits64) - bits64, dev)
        ids = huffman_decode.huffman_decode_probe(*args, **kw)
        par.compare("huffman_decode", case, ids, ref.huffman_decode_ref(*args, **kw))
        got = torch.from_numpy(codec.alphabet).to(dev)[ids.reshape(-1)[: sym.size]]
        check(torch.equal(got, flat), f"huffman round trip [{case}] lost symbols")
    emit({"phase": "edges", "cases": par.cases, "max_abs_err": par.err})


def main_path(x_np):
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.sz import TiledCompressed, compress_tiled, decompress_region
    from repro_torch.sz import decompress_tiled

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    art, recon = compress_tiled(x_np, TILE, rel_eb=REL_EB, backend=BACKEND)
    blob = art.to_bytes()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = TiledCompressed.from_bytes(blob)
    out = decompress_tiled(back)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    region = decompress_region(back, ROI)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(ops.LAUNCHES)

    x = torch.from_numpy(x_np).to(out.device)
    check(tuple(out.shape) == SHAPE and out.dtype == torch.float32, "decode shape/dtype")
    check(bool(torch.isfinite(out).all()), "non-finite values in the decode")
    err = float((x.double() - out.double()).abs().max())
    check(err <= art.eb_abs * (1 + 1e-6), f"error {err} above eb {art.eb_abs}")
    check(torch.equal(out, recon), "decode differs from the compress-time reconstruction")
    crop = out[tuple(slice(a, b) for a, b in ROI)]
    check(torch.equal(region, crop), "region decode differs from the full decode's crop")
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    emit({"phase": "main", "shape": list(SHAPE), "tile": list(TILE), "rel_eb": REL_EB,
          "backend": BACKEND, "eb_abs": art.eb_abs, "compress_s": t1 - t0,
          "decompress_s": t2 - t1, "region_ms": (t3 - t2) * 1e3, "roi": [list(r) for r in ROI],
          "region_tiles": int(np.prod([-(-b // t) - a // t for (a, b), t in zip(ROI, TILE)])),
          "ratio": x_np.nbytes / len(blob), "container_bytes": len(blob),
          "max_abs_err": err, "launches": launches})
    return art, blob, launches


def kernel_rows(par: Parity, x_np, art, launches) -> list[dict]:
    """Parity and timing of each kernel on the main path's own shapes."""
    import numpy as np
    import torch

    from repro_torch.kernels import group_hist, huffman_decode, huffman_encode, ref
    from repro_torch.kernels import lorenzo_quant
    from repro_torch.sz import entropy, tiled

    dev = torch.device("cuda")
    x = torch.from_numpy(x_np).to(dev)
    tiles = tiled.split_tiles(tiled.pad_to_tiles(x, TILE), TILE).contiguous()
    eb = art.eb_abs
    sizes = [len(b) for b in art.tile_blobs]
    lane = int(np.argsort(sizes)[len(sizes) // 2])  # the median-size lane
    rows = {}

    def row(name, kern, plain, nbytes, nops, library=None, reps=200, plain_reps=20):
        ms, ms_by = kernel_ms(kern, KERNELS[name][2], reps)
        rows[name] = {
            "ms": ms, "ms_by": ms_by, "call_ms": events_ms(kern, reps),
            "plain_ms": events_ms(plain, plain_reps),
            "library_ms": None if library is None else events_ms(library, reps),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= nops / FP32_OPS_PER_S
            else "operations",
            "shape_note": None}

    codes = lorenzo_quant.lorenzo_quant_tiles(tiles, eb)
    par.compare("lorenzo_quant_tiles", "main_512x64^3", codes,
                ref.lorenzo_quant_tiles_ref(tiles, eb))
    n = tiles.numel()
    # bytes: read x, write codes; operations: 1 division + 7 adds per element
    row("lorenzo_quant_tiles", lambda: lorenzo_quant.lorenzo_quant_tiles(tiles, eb),
        lambda: ref.lorenzo_quant_tiles_ref(tiles, eb), 8 * n, 8 * n, reps=20, plain_reps=5)
    rows["lorenzo_quant_tiles"]["shape_note"] = f"x {list(tiles.shape)} f32"

    flat = codes[lane].reshape(-1)
    lo, hi = torch.stack(torch.aminmax(flat)).tolist()
    shifted = flat - lo
    span = hi - lo + 1
    par.compare("symbol_hist", "main_lane", group_hist.symbol_hist(shifted, span),
                ref.symbol_hist_ref(shifted, span))
    shifted64 = shifted.to(torch.int64)
    row("symbol_hist", lambda: group_hist.symbol_hist(shifted, span),
        lambda: ref.symbol_hist_ref(shifted, span), 4 * shifted.numel() + 4 * span,
        shifted.numel(), library=lambda: torch.bincount(shifted64, minlength=span))
    rows["symbol_hist"]["shape_note"] = f"{shifted.numel()} symbols, {span} bins"

    codec = entropy.HuffmanCodec.fit(flat)
    lens, cws = codec._pack_inputs(flat, entropy.DEFAULT_CHUNK)
    par.compare("huffman_encode", "main_lane", huffman_encode.huffman_encode_pack(lens, cws),
                ref.huffman_encode_ref(lens, cws))
    C, cs = lens.shape
    # bytes: read lens + codes, write words + chunk_bits; ~12 int ops a symbol
    row("huffman_encode", lambda: huffman_encode.huffman_encode_pack(lens, cws),
        lambda: ref.huffman_encode_ref(lens, cws), 12 * C * cs + 4 * C, 12 * C * cs)
    rows["huffman_encode"]["shape_note"] = f"lens/codes [{C}, {cs}] i32"

    dcodec, n_sym, dcs, chunk_bits, stream, _ = entropy.parse_chunked(art.tile_blobs[lane])
    cb = np.asarray(chunk_bits, np.int64)
    args, kw = dcodec._decode_inputs(stream, n_sym, dcs, np.cumsum(cb) - cb, dev)
    ids = huffman_decode.huffman_decode_probe(*args, **kw)
    par.compare("huffman_decode", "main_lane", ids, ref.huffman_decode_ref(*args, **kw))
    # bytes: the stream's words, the chunk offsets and counts read, the ids
    # written (the codec's tables are left out: they derive from its header)
    n_words = -(-int(cb.sum()) // 32)
    nbytes = 4 * (n_words + args[1].numel() + args[2].numel() + ids.numel())
    row("huffman_decode", lambda: huffman_decode.huffman_decode_probe(*args, **kw),
        lambda: ref.huffman_decode_ref(*args, **kw), nbytes, 16 * n_sym, plain_reps=5)
    rows["huffman_decode"]["shape_note"] = (f"{args[0].numel()} stream words, "
                                            f"ids [{ids.shape[0]}, {ids.shape[1]}]")

    out = []
    for name, (source, replaces, _) in KERNELS.items():
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[name], "max_abs_err": par.err[name],
                    "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "ms_by": r["ms_by"], "call_ms": r["call_ms"], "shape": r["shape_note"]})
    return out


def cpu_vs_card(x_np) -> None:
    import numpy as np

    from repro_torch.sz import compress_tiled

    corner = np.ascontiguousarray(x_np[:128, :128, :128])
    t0 = time.perf_counter()
    card, _ = compress_tiled(corner, TILE, rel_eb=REL_EB, backend=BACKEND)
    t1 = time.perf_counter()
    cpu, _ = compress_tiled(corner, TILE, rel_eb=REL_EB, backend=BACKEND, device="cpu")
    t2 = time.perf_counter()
    same = card.to_bytes() == cpu.to_bytes()
    check(same, "card and CPU GWTC bytes differ on the 128^3 corner")
    emit({"phase": "cpu", "shape": [128, 128, 128], "bytes_identical": same,
          "card_s": t1 - t0, "cpu_s": t2 - t1})


def golden() -> None:
    import numpy as np

    from repro_torch.sz import TiledCompressed, decompress_tiled

    gold = ROOT / "tests" / "golden"
    art = TiledCompressed.from_bytes((gold / "gwtc_v1.bin").read_bytes())
    got = decompress_tiled(art).cpu().numpy()
    want = np.load(gold / "gwtc_v1_decode.npy")
    check(got.shape == want.shape and np.array_equal(got, want),
          "gwtc_v1.bin does not decode bit-exact")
    emit({"phase": "golden", "file": "tests/golden/gwtc_v1.bin", "bit_exact": True})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.data import nyx_like_field
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    per_source = _build.build()
    ptxas = {name: [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                    if "Used" in ln] for name, log in _build.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source_s": per_source,
          "ptxas": ptxas, "torch": torch.__version__, "cuda": torch.version.cuda})

    par = Parity()
    edge_parity(par)

    t0 = time.perf_counter()
    x_np = nyx_like_field(SHAPE, "temperature", seed=0)
    emit({"phase": "field", "shape": list(SHAPE), "seconds": time.perf_counter() - t0})

    art, blob, launches = main_path(x_np)
    rows = kernel_rows(par, x_np, art, launches)
    del blob
    cpu_vs_card(x_np)
    golden()

    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
