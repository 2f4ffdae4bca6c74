#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs nvcc and a CUDA card

Phases (any failure raises and the script exits non-zero):

1. build   -- compile the six CUDA sources (seven kernels) from
              ``src/repro_torch/csrc`` (one nvcc per source, all at once)
              and time it;
2. edges   -- each kernel against its plain PyTorch version on the card on
              edge cases; bit for bit (tolerance 0) for the integer kernels:
              .5 ties, negatives, |q| near 2**25, ragged tiles and ranks
              0-2, z across the volume kernel's 32-plane segments, spans
              above 4096, short last chunks, codes longer than the 12-bit
              LUT up to the 32-bit maximum codeword, values on / below /
              above the group edges, duplicate edges, G = 1, 20 and the
              largest G; for ``enhancer_fused`` within
              |diff| <= 1e-5 (1 + max|plain|) (the kernel fuses multiply-adds
              the plain version rounds twice): G = 1 on 1x1 .. 64x64 slices,
              ids changing inside the halo, an inactive group, the clamp,
              direct (non-residual) mode;
3. main    -- the main path at full size: nyx_like_field((512,)*3,
              "temperature", seed=0), tile 64^3, rel_eb 1e-3, huffman+zlib,
              through compress_tiled -> to_bytes -> from_bytes ->
              decompress_tiled and decompress_region; launch counters are
              zeroed just before and read just after (as in every phase
              below);
4. gwlz    -- the GWLZ enhancer path on the same field at the paper's model
              width (G = 20, C = 9, batch 10; 1 epoch, cut from 300):
              GWLZ.compress_tiled -> to_bytes -> from_bytes -> enhanced
              decompress_tiled and decompress_region.  Checks: the decode's
              PSNR equals the compress-time psnr_gwlz, region == full crop
              bit for bit, psnr_gwlz >= psnr_sz - 1e-3, group_hist and
              enhancer_fused launched.  On this field at rel_eb 1e-3 the
              quantile edges collapse and only 2 of the 20 groups hold values;
5. gwlz_all_groups -- the same path and checks on
              nyx_like_field((512,)*3, "velocity_x", seed=0), where all 20
              quantile groups hold values (checked), so every model trains
              and the grouped kernel meets group borders everywhere;
6. szjx    -- the monolithic SZ path through the façade on the temperature
              field: api.compress(predictor="lorenzo", not tiled) -> api.save
              -> api.open -> np.asarray(vol) and vol[the main ROI].  Checks:
              max error <= eb (1 + 1e-6), decode == compress-time
              reconstruction and slice == full crop bit for bit; the 128^3
              corner's SZJX bytes equal on the card and the CPU;
              lorenzo_quant, huffman_encode and huffman_decode launched;
7. gwlz_mono -- the paper's configuration: api.compress(predictor="lorenzo",
              enhance=GWLZTrainConfig(epochs=5)) on the same field, the
              enhancers trained on 512 full 512x512 slices (51 steps an
              epoch; 5 epochs, cut from 300), then save, open, full decode
              and the ROI.  Checks as for gwlz;
8. cli     -- ``python -m repro_torch.cli`` in subprocesses on
              synthetic:temperature:64, tiled (tile 16) and monolithic,
              Lorenzo: compress -> info -> region -> decompress -> verify;
              the ROI equals the full crop, verify exits 0, and 1 on a copy
              with one byte of one lane flipped;
9. kernels -- each kernel again at its path's shapes: against its plain
              version, then timed (see ``kernel_ms`` and
              ``launch_events_ms``) beside the plain version, a library call
              where one exists, and the bound (the larger of bytes over
              3.35 TB/s and operations over 67 TFLOP/s; for the enhancer
              the operations this run's group ids need, see
              ``enhancer_flop``); group_hist and enhancer_fused on both
              gwlz runs' decodes; huffman_decode and enhancer_fused also at
              the monolithic shapes (``mono``);
10. cpu    -- the 128^3 corner compressed on the card and on the CPU gives
              identical GWTC bytes;
11. golden -- tests/golden/gwtc_v1.bin and szjx_lorenzo.bin decode on the
              card bit for bit.

Each phase prints a JSON line.  Then come the ``kernels`` line, the card's
name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM non-tensor float32 / int32 rate
SHAPE, TILE, REL_EB, BACKEND = (512, 512, 512), (64, 64, 64), 1e-3, "huffman+zlib"
GWLZ_EPOCHS = 1  # the paper trains 300 epochs (~1M steps at 512^3): no smoke
MONO_EPOCHS = 5  # gwlz_mono: 51 steps an epoch on 512 slices of 512x512
GWLZ_FIELDS = {"gwlz": "temperature", "gwlz_all_groups": "velocity_x"}  # phase -> field
ROI = ((100, 228), (37, 101), (300, 364))
KERNELS = {  # counter name -> (source, TPU kernel it replaces, __global__ name prefix)
    "lorenzo_quant_tiles": ("src/repro_torch/csrc/lorenzo_quant.cu",
                            "src/repro/kernels/lorenzo_quant.py:87",
                            "lorenzo_quant_tiles_kernel"),
    "lorenzo_quant": ("src/repro_torch/csrc/lorenzo_quant.cu",
                      "src/repro/kernels/lorenzo_quant.py:55", "lorenzo_quant_volume_kernel"),
    "symbol_hist": ("src/repro_torch/csrc/symbol_hist.cu",
                    "src/repro/kernels/group_hist.py:53", "symbol_hist_"),
    "huffman_encode": ("src/repro_torch/csrc/huffman_encode.cu",
                       "src/repro/kernels/huffman_encode.py:72",
                       "huffman_encode_pack_kernel"),
    "huffman_decode": ("src/repro_torch/csrc/huffman_decode.cu",
                       "src/repro/kernels/huffman_decode.py:106",
                       "huffman_decode_probe_kernel"),
    "group_hist": ("src/repro_torch/csrc/group_hist.cu",
                   "src/repro/kernels/group_hist.py:73", "group_hist_kernel"),
    "enhancer_fused": ("src/repro_torch/csrc/enhancer_fused.cu",
                       "src/repro/kernels/enhancer_fused.py:68", "enhancer_grouped_kernel"),
}
GWLZ_KERNELS = ("group_hist", "enhancer_fused")  # counted on the gwlz path
SZJX_KERNELS = ("lorenzo_quant", "huffman_encode", "huffman_decode")  # needed on szjx
# the path whose launches each kernel's row reports
LAUNCH_PATH = {**{k: "main" for k in KERNELS}, "lorenzo_quant": "szjx",
               **{k: "gwlz" for k in GWLZ_KERNELS}}
ENHANCE_RTOL = 1e-5  # |kernel - plain| <= ENHANCE_RTOL * (1 + max|plain|)


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


def launch_events_ms(fn, reps: int) -> tuple[float, str]:
    """Device time of one launch: a pair of CUDA events around each of
    ``reps`` calls, all queued behind a device-side sleep so no host gap
    falls inside a pair; the mean interval.  For calls of one long launch,
    where the wrapper's own work is a rounding error.  Returns (ms, method)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(int(1.5 * reps * one_s * 2e9))  # cycles; the clock is <= 2 GHz
    for a, b in pairs:
        a.record()
        fn()
        b.record()
    pairs[-1][1].synchronize()
    return (sum(a.elapsed_time(b) for a, b in pairs) / reps,
            f"events, 1 launch per interval, {reps} intervals")


def kernel_ms(fn, kernel: str, reps: int, traces: int = 3) -> tuple[float, str]:
    """Device time of the kernel alone: its own intervals in a torch.profiler
    trace of ``reps`` calls, over their launches, so the wrapper's host work
    and output allocation are left out.

    The profiler keeps only the device activity that falls inside its
    capture window, and it takes the window's ends from the host's clock: a
    launch that starts as the window opens, or ends as it closes, can be
    dropped when the device's clock runs apart from the host's.  So each
    trace follows a warm-up step whose events are dropped, its calls are
    queued behind a device-side sleep of at least 20 ms, and the window
    closes 20 ms after the last launch has finished.  Only a trace that
    holds every launch counts: one that lost launches is taken again, up to
    ``traces`` in all.  If every trace lost launches, or the profiler
    records no device time, the kernel is timed with CUDA events around each
    call instead (:func:`launch_events_ms`: the wrapper's own device work,
    such as zeroing a histogram, counts then), and the method says so.
    Returns (ms, method)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    lead_cycles = int(max(0.02, 1.5 * (time.perf_counter() - t0)) * 2e9)  # clock <= 2 GHz
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    lost = []
    for _ in range(traces):
        warm_then_trace = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=warm_then_trace) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            torch.cuda._sleep(lead_cycles)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
            prof.step()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key
                and e.self_device_time_total > 0]
        count = sum(e.count for e in hits)
        if count == 0:
            lost.append("no device time")
            break
        if count == reps:
            return (sum(e.self_device_time_total for e in hits) / count / 1e3,
                    f"profiler {count}/{reps}"
                    + (f" (earlier traces held {lost})" if lost else ""))
        lost.append(f"{count}/{reps}")
    ms, how = launch_events_ms(fn, reps)
    return ms, f"{how} (profiler traces held {lost})"


class Parity:
    """Runs kernel-vs-plain comparisons and keeps each kernel's worst error
    (and, for float kernels, the tolerance it was held to)."""

    def __init__(self):
        self.err = {name: 0 for name in KERNELS}
        self.cases = {name: 0 for name in KERNELS}
        self.tol = {name: 0 for name in KERNELS}

    def compare(self, name: str, case: str, got, want) -> None:
        import torch

        torch.cuda.synchronize()  # a fault during the kernel surfaces here
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        err = max(max_abs_err(g, w) for g, w in pairs)
        self.err[name] = max(self.err[name], err)
        self.cases[name] += 1
        check(err == 0, f"{name} [{case}] differs from its plain version by {err}")

    def compare_float(self, name: str, case: str, got, want, rtol: float) -> None:
        """|got - want| <= rtol (1 + max|want|), both finite."""
        import torch

        torch.cuda.synchronize()
        check(got.shape == want.shape, f"{name} [{case}] shape {tuple(got.shape)} != "
              f"{tuple(want.shape)}")
        check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()),
              f"{name} [{case}] has non-finite values")
        err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        tol = rtol * (1 + (float(want.abs().max()) if want.numel() else 0.0))
        self.err[name] = max(self.err[name], err)
        self.tol[name] = max(self.tol[name], tol)
        self.cases[name] += 1
        check(err <= tol, f"{name} [{case}] differs from its plain version by {err} > {tol}")


def edge_parity(par: Parity) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import enhancer_fused, group_hist, huffman_decode
    from repro_torch.kernels import huffman_encode, lorenzo_quant, ref
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
    # the whole-volume kernel: z across its 32-plane segments, ragged windows,
    # ranks 0-2
    for case, x in {
        "ties_negatives_ragged": ties[0],
        "q_near_2^25": cases["q_near_2^25"][0],
        "z33_segments": rng.normal(0, 100, (33, 17, 45)).astype(np.float32),
        "z64_x70": rng.normal(0, 100, (64, 9, 70)).astype(np.float32),
        "rank2": cases["rank2"][0],
        "rank1": cases["rank1"][0],
        "rank0": np.float32(3.7 * two),
    }.items():
        xt = torch.from_numpy(np.asarray(x)).to(dev)
        par.compare("lorenzo_quant", case, lorenzo_quant.lorenzo_quant(xt, eb),
                    ref.lorenzo_quant_ref(xt, eb))

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

    # group_hist: values on every edge, below the first and above the last,
    # duplicate edges, G = 1, 20 and the largest G, sizes off the block
    for case, (G, n) in {"G1": (1, 1000), "G20_dup_edges": (20, 262147),
                         "G20_ragged": (20, 77), f"G{group_hist.MAX_GROUPS}":
                         (group_hist.MAX_GROUPS, 100003)}.items():
        edges = np.sort(rng.normal(0, 1, G + 1)).astype(np.float32)
        if G > 4:
            edges[3:5] = edges[2]
        vals = np.concatenate([edges, [edges[0] - 1, edges[-1] + 1, -np.inf, np.inf],
                               rng.normal(0, 1.5, n)]).astype(np.float32)
        xt, et = torch.from_numpy(vals).to(dev), torch.from_numpy(edges).to(dev)
        par.compare("group_hist", case, group_hist.group_hist(xt, et),
                    ref.group_hist_ref(xt, et))

    # enhancer_fused: the TPU kernel's G = 1 contract on assorted shapes, then
    # the grouped form with ids changing inside every halo
    C = 9

    def f(*shape, scale=0.5):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)).to(dev)

    p1 = {"w1": f(3, 3, 1, C), "b1": f(C), "gamma": f(C) + 1, "beta": f(C),
          "w2": f(3, 3, C, 1), "b2": f(1)}
    s1 = {"mean": f(C), "var": f(C).abs() + 0.5}
    order = ("w1", "b1", "gamma", "beta")
    for shape in [(2, 1, 1), (3, 3, 100), (2, 17, 45), (2, 64, 64)]:
        xt = f(*shape, scale=1.0)
        single = enhancer_fused.single_enhancer(*(p1[k] for k in order), s1["mean"],
                                                s1["var"], p1["w2"], p1["b2"])
        got = enhancer_fused.enhancer_grouped(xt, None, single, mode="pred")
        want = ref.enhancer_fused_ref(xt, *(p1[k] for k in order), s1["mean"], s1["var"],
                                      p1["w2"], p1["b2"])
        par.compare_float("enhancer_fused", f"G1_{shape[1]}x{shape[2]}", got, want,
                          ENHANCE_RTOL)
    G = 20
    lo = torch.from_numpy(np.sort(rng.normal(0, 1, G)).astype(np.float32)).to(dev)
    rscale = f(G).abs() + 0.01
    rscale[3] = 0.0  # an inactive group
    packed = enhancer_fused.pack_enhancers(lo, f(G).abs() + 0.1, f(G), rscale, f(G, 9, C), f(G, C),
                                f(G, C).abs() + 0.5, f(G, C), f(G, 9, C))
    xt = f(4, 50, 70, scale=1.0)
    ids = torch.from_numpy(rng.integers(0, G, xt.shape).astype(np.int32)).to(dev)
    for case, mode, clamp in [("grouped_pred", "pred", None),
                              ("grouped_residual_inactive", "residual", None),
                              ("grouped_clamp", "residual", 0.01),
                              ("grouped_direct", "direct", None)]:
        got = enhancer_fused.enhancer_grouped(xt, ids, packed, mode=mode, clamp_eb=clamp)
        want = ref.enhancer_grouped_ref(xt, ids, packed, mode=mode, clamp_eb=clamp)
        par.compare_float("enhancer_fused", case, got, want, ENHANCE_RTOL)
        if mode == "residual":
            check(torch.equal(got[ids == 3], xt[ids == 3]), "an inactive group changed x")
        if clamp is not None:
            check(bool(((got - xt).abs() <= clamp + 1e-6).all()), "the clamp let a value out")
    emit({"phase": "edges", "cases": par.cases, "max_abs_err": par.err,
          "float_tolerance": {k: v for k, v in par.tol.items() if v}})


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
    check(all(launches[k] > 0 for k in KERNELS if LAUNCH_PATH[k] == "main"),
          f"a kernel never launched: {launches}")
    emit({"phase": "main", "shape": list(SHAPE), "tile": list(TILE), "rel_eb": REL_EB,
          "backend": BACKEND, "eb_abs": art.eb_abs, "compress_s": t1 - t0,
          "decompress_s": t2 - t1, "region_ms": (t3 - t2) * 1e3, "roi": [list(r) for r in ROI],
          "region_tiles": int(np.prod([-(-b // t) - a // t for (a, b), t in zip(ROI, TILE)])),
          "ratio": x_np.nbytes / len(blob), "container_bytes": len(blob),
          "max_abs_err": err, "launches": launches})
    return art, blob, launches


def gwlz_path(x_np, phase: str):
    """The enhancer path: GWLZ compress (SZ, training, calibration, gate,
    enhancement), container round trip, enhanced full and region decode."""
    import numpy as np
    import torch

    from repro_torch.core import metrics
    from repro_torch.core.pipeline import GWLZ, GWLZTrainConfig, deserialize_model
    from repro_torch.kernels import ops
    from repro_torch.sz import TiledCompressed

    cfg = GWLZTrainConfig(epochs=GWLZ_EPOCHS)
    gw = GWLZ(train_cfg=cfg)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    art, stats = gw.compress_tiled(x_np, TILE, rel_eb=REL_EB, predictor="lorenzo")
    blob = art.to_bytes()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = TiledCompressed.from_bytes(blob)
    out = gw.decompress_tiled(back)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    region = gw.decompress_region(back, ROI)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(ops.LAUNCHES)

    x = torch.from_numpy(x_np).to(out.device)
    check(tuple(out.shape) == SHAPE and bool(torch.isfinite(out).all()), "gwlz decode shape")
    psnr = float(metrics.psnr(x, out))
    check(psnr == stats.psnr_gwlz, f"decode PSNR {psnr} != compress-time {stats.psnr_gwlz}")
    crop = out[tuple(slice(a, b) for a, b in ROI)]
    check(torch.equal(region, crop), "enhanced region differs from the full decode's crop")
    check(stats.psnr_gwlz >= stats.psnr_sz - 1e-3,
          f"enhancement lost PSNR: {stats.psnr_sz} -> {stats.psnr_gwlz}")
    check(all(launches[k] > 0 for k in GWLZ_KERNELS), f"an enhancer kernel never ran: {launches}")
    model = deserialize_model(art.extras["gwlz"])
    trained = int((np.asarray(stats.loss_history[-1]) > 0).sum())  # groups holding values
    if phase == "gwlz_all_groups":
        check(trained == cfg.n_groups, f"only {trained} of {cfg.n_groups} groups trained")
    sec = stats.seconds
    steps = (np.prod(SHAPE) // (TILE[1] * TILE[2])) // cfg.batch_size * cfg.epochs
    emit({"phase": phase, "field": GWLZ_FIELDS[phase], "shape": list(SHAPE),
          "tile": list(TILE), "rel_eb": REL_EB,
          "n_groups": cfg.n_groups, "channels": cfg.channels, "batch_size": cfg.batch_size,
          "epochs": cfg.epochs, "steps": int(steps), "compress_s": t1 - t0,
          "seconds": sec, "train_ms_per_step": 1e3 * sec["train"] / steps,
          "decompress_s": t2 - t1, "region_ms": (t3 - t2) * 1e3,
          "psnr_sz": stats.psnr_sz, "psnr_gwlz": stats.psnr_gwlz, "psnr_decode": psnr,
          "overhead": stats.overhead, "ratio_sz": stats.cr_sz, "ratio_gwlz": stats.cr_gwlz,
          "max_err_sz": stats.max_err_sz, "max_err_gwlz": stats.max_err_gwlz,
          "model_params": stats.n_model_params,
          "trained_groups": trained, "active_groups": int((model.rscale > 0).sum()),
          "distinct_edges": int(torch.unique(model.edges).numel()),
          "loss_epoch0": [round(float(v), 6) for v in stats.loss_history[0]],
          "launches": launches})
    return art, model, launches


def roi_key():
    return tuple(slice(a, b) for a, b in ROI)


def szjx_path(x_np, tmp: Path):
    """The monolithic SZ path through the façade: compress, save, open, full
    decode and the main ROI."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.sz import SZCompressor

    path = tmp / "field.szjx"
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = api.compress(x_np, eb=REL_EB, predictor="lorenzo", backend=BACKEND)
    n = api.save(path, vol)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with api.open(path) as back:
        full = np.asarray(back)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        region = back[roi_key()]
        t3 = time.perf_counter()
        art = back.artifact
    launches = dict(ops.LAUNCHES)

    x = torch.from_numpy(x_np).cuda()
    eb = art.eb_abs
    out = torch.from_numpy(full.copy()).cuda()
    check(full.shape == SHAPE and bool(torch.isfinite(out).all()), "szjx decode shape")
    err = float((x.double() - out.double()).abs().max())
    check(err <= eb * (1 + 1e-6), f"szjx error {err} above eb {eb}")
    # the compress-time reconstruction, from the compressor itself (after
    # the counters were read); compress is deterministic
    again, recon = SZCompressor("lorenzo", backend=BACKEND).compress(x, rel_eb=REL_EB)
    check(again.to_bytes() == path.read_bytes(), "szjx compress is not deterministic")
    check(torch.equal(out, recon), "szjx decode differs from the compress-time reconstruction")
    del again, recon
    check(np.array_equal(region, full[roi_key()]), "szjx slice differs from the full crop")
    check(all(launches[k] > 0 for k in SZJX_KERNELS), f"a szjx kernel never launched: {launches}")
    corner = np.ascontiguousarray(x_np[:128, :128, :128])
    card = SZCompressor("lorenzo", backend=BACKEND).compress(corner, rel_eb=REL_EB)[0]
    cpu = SZCompressor("lorenzo", backend=BACKEND).compress(corner, rel_eb=REL_EB,
                                                            device="cpu")[0]
    check(card.to_bytes() == cpu.to_bytes(), "card and CPU SZJX bytes differ on the corner")
    emit({"phase": "szjx", "shape": list(SHAPE), "rel_eb": REL_EB, "backend": BACKEND,
          "eb_abs": eb, "compress_s": t1 - t0, "decompress_s": t2 - t1,
          "region_ms": (t3 - t2) * 1e3, "roi": [list(r) for r in ROI], "ratio": x_np.nbytes / n,
          "container_bytes": n, "max_abs_err": err, "corner_bytes_identical": True,
          "symbols": int(np.prod(SHAPE)), "launches": launches})
    return art, launches


def gwlz_mono_path(x_np, tmp: Path):
    """The paper's configuration: monolithic SZ, enhancers trained on the
    full 512x512 slices, through the façade."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.core import metrics
    from repro_torch.core.pipeline import GWLZTrainConfig
    from repro_torch.kernels import ops

    cfg = GWLZTrainConfig(epochs=MONO_EPOCHS)
    path = tmp / "field_gwlz.szjx"
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = api.compress(x_np, eb=REL_EB, predictor="lorenzo", backend=BACKEND, enhance=cfg)
    api.save(path, vol)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with api.open(path) as back:
        full = np.asarray(back)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        region = back[roi_key()]
        t3 = time.perf_counter()
        art = back.artifact
    launches = dict(ops.LAUNCHES)

    stats = vol.train_stats
    x = torch.from_numpy(x_np).cuda()
    out = torch.from_numpy(full.copy()).cuda()
    check(full.shape == SHAPE and bool(torch.isfinite(out).all()), "gwlz_mono decode shape")
    psnr = float(metrics.psnr(x, out))
    check(psnr == stats.psnr_gwlz, f"decode PSNR {psnr} != compress-time {stats.psnr_gwlz}")
    check(np.array_equal(region, full[roi_key()]), "enhanced slice differs from the full crop")
    check(stats.psnr_gwlz >= stats.psnr_sz - 1e-3,
          f"enhancement lost PSNR: {stats.psnr_sz} -> {stats.psnr_gwlz}")
    check(all(launches[k] > 0 for k in GWLZ_KERNELS + SZJX_KERNELS),
          f"a kernel of the path never ran: {launches}")
    from repro_torch.core.pipeline import deserialize_model

    model = deserialize_model(art.extras["gwlz"])
    sec = stats.seconds
    steps = SHAPE[0] // cfg.batch_size * cfg.epochs
    emit({"phase": "gwlz_mono", "field": "temperature", "shape": list(SHAPE),
          "rel_eb": REL_EB, "n_groups": cfg.n_groups, "channels": cfg.channels,
          "batch_size": cfg.batch_size, "epochs": cfg.epochs, "steps": steps,
          "compress_s": t1 - t0, "seconds": sec,
          "train_ms_per_step": 1e3 * sec["train"] / steps, "decompress_s": t2 - t1,
          "region_ms": (t3 - t2) * 1e3, "psnr_sz": stats.psnr_sz,
          "psnr_gwlz": stats.psnr_gwlz, "psnr_decode": psnr, "overhead": stats.overhead,
          "ratio_sz": stats.cr_sz, "ratio_gwlz": stats.cr_gwlz,
          "max_err_sz": stats.max_err_sz, "max_err_gwlz": stats.max_err_gwlz,
          "trained_groups": int((np.asarray(stats.loss_history[-1]) > 0).sum()),
          "active_groups": int((model.rscale > 0).sum()),
          "loss_per_epoch": [[round(float(v), 6) for v in row] for row in stats.loss_history],
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches})
    return art, model, launches


def cli_path(tmp: Path) -> None:
    """``python -m repro_torch.cli`` end to end in subprocesses (default
    device: the card), tiled and monolithic."""
    import numpy as np

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    roi = "8:40,0:16,20:52"
    took = {}

    def run(*argv, want=0):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.cli", *argv], env=env,
                           capture_output=True, text=True, timeout=300)
        took.setdefault(argv[0], []).append(time.perf_counter() - t)
        check(r.returncode == want, f"cli {' '.join(argv)} exited {r.returncode}, not "
              f"{want}: {r.stderr[-2000:]}")
        return r.stdout

    sizes = {}
    for mode, flags in (("tiled", ["--tiled", "--tile", "16"]), ("mono", [])):
        f = str(tmp / f"cli_{mode}.gw")
        run("compress", "synthetic:temperature:64", f, "--eb", "1e-3", "--predictor",
            "lorenzo", *flags)
        run("info", f)
        run("region", f, "--roi", roi, "--out", str(tmp / f"roi_{mode}.npy"))
        run("decompress", f, str(tmp / f"full_{mode}.npy"))
        run("verify", f)
        full, part = np.load(tmp / f"full_{mode}.npy"), np.load(tmp / f"roi_{mode}.npy")
        check(np.array_equal(part, full[8:40, 0:16, 20:52]), f"cli {mode}: ROI != full crop")
        sizes[mode] = os.path.getsize(f)
    from repro_torch.sz import TiledCompressed, tiled

    blob = bytearray((tmp / "cli_tiled.gw").read_bytes())
    art = TiledCompressed.from_bytes(bytes(blob))
    blob[tiled.lane_offset(art, 5) + 7] ^= 0x20
    bad = tmp / "cli_bad.gw"
    bad.write_bytes(bytes(blob))
    run("verify", str(bad), want=1)
    emit({"phase": "cli", "input": "synthetic:temperature:64", "roi": roi,
          "container_bytes": sizes, "flipped_lane_verify_exit": 1,
          "seconds": {k: [round(v, 3) for v in vs] for k, vs in took.items()}})


def time_row(rows, name, kern, plain, nbytes, nops, library=None, reps=200, plain_reps=20,
             timer=None):
    """Time kernel, plain version and library call; store the row with its
    bound (the larger of bytes over HBM rate and operations over the
    float32 rate).  ``timer`` times the kernel (default: the profiler)."""
    ms, ms_by = (timer or functools.partial(kernel_ms, kernel=KERNELS[name][2]))(kern,
                                                                               reps=reps)
    rows[name] = {
        "ms": ms, "ms_by": ms_by, "call_ms": events_ms(kern, reps),
        "plain_ms": events_ms(plain, plain_reps),
        "library_ms": None if library is None else events_ms(library, reps),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= nops / FP32_OPS_PER_S
        else "operations",
        "shape_note": None}


def enhancer_flop(n: int, ids, live, C: int) -> tuple[int, float]:
    """Operations the group-wise enhancer needs on ``n`` pixels of slices
    whose groups are ``ids`` ([B, H, W] int32; None: all group 0), when only
    the groups in ``live`` have an output: 2 flop for each FMA.  A hidden
    value h_g(q) (9 taps x C channels of FMAs) is needed once for every
    in-slice pixel q and group g that some pixel of q's 3x3 neighbourhood
    belongs to; each output pixel of a live group adds the 9C FMAs of conv2.
    Returns (flop, hidden values needed per pixel)."""
    import torch
    import torch.nn.functional as F

    if ids is None:
        n_h = n_out = n
    else:
        n_h = n_out = 0
        for g in live:
            m = (ids == g)[:, None].to(torch.float32)
            n_out += int(torch.count_nonzero(m))
            n_h += int(torch.count_nonzero(F.max_pool2d(m, 3, stride=1, padding=1)))
            del m
    return 2 * 9 * C * (n_h + n_out), n_h / n


def tile_slices(gw_art):
    """Every decoded tile of a tiled artifact as one stack of slices."""
    from repro_torch.sz.tiled import decode_lanes

    recon, _ = decode_lanes(gw_art, range(gw_art.n_tiles))
    return recon.reshape((-1,) + tuple(TILE[1:])).contiguous()


def gwlz_kernel_rows(par: Parity, xs, model, case: str, mode: str, with_g1: bool) -> dict:
    """Parity and timing of group_hist and enhancer_fused on the decoded
    slices ``xs`` [B, H, W], with the trained model's edges and table: the
    enhanced full decode's launch (``mode="residual"``) or the gate's
    (``"pred"``, every group with an output).  ``with_g1`` adds the TPU
    kernel's own G = 1 contract on the same slices."""
    import torch

    from repro_torch.core import enhancer
    from repro_torch.kernels import enhancer_fused, group_hist, ref

    rows = {}
    row = functools.partial(time_row, rows)
    edges = model.edges
    G = edges.numel() - 1
    ids, hist = group_hist.group_hist(xs, edges)
    par.compare("group_hist", f"{case}_decode", (ids, hist), ref.group_hist_ref(xs, edges))
    bounds = edges[1:-1].contiguous()
    n = xs.numel()
    # bytes: read x, write ids (+ edges, hist); operations: G compares a value
    row("group_hist", lambda: group_hist.group_hist(xs, edges),
        lambda: ref.group_hist_ref(xs, edges), 8 * n + 8 * G + 4, G * n,
        library=lambda: torch.bincount(torch.bucketize(xs, bounds, right=True).reshape(-1),
                                       minlength=G), reps=20, plain_reps=2)
    filled = int((hist > 0).sum())
    rows["group_hist"]["shape_note"] = (f"x {list(xs.shape)} f32, {G} groups, "
                                        f"{filled} holding values")

    packed = model.packed()
    C = enhancer.DEFAULT_CHANNELS
    # held in prediction units (the residual epilogue adds x, which would
    # swamp a relative tolerance); then the residual output to the same
    # bound scaled by rscale, plus the rounding of x + rhat
    got = enhancer_fused.enhancer_grouped(xs, ids, packed, mode="pred")
    want = ref.enhancer_grouped_ref(xs, ids, packed, mode="pred")
    par.compare_float("enhancer_fused", f"{case}_decode_pred", got, want, ENHANCE_RTOL)
    tol = ENHANCE_RTOL * (1 + float(want.abs().max())) * float(model.rscale.max())
    del got, want
    if mode == "residual":
        got = enhancer_fused.enhancer_grouped(xs, ids, packed, mode=mode)
        diff = (got - ref.enhancer_grouped_ref(xs, ids, packed, mode=mode)).abs()
        check(bool((diff <= tol + torch.abs(xs) * 2**-23).all()),
              f"enhancer_fused [{case}] residual output off by {float(diff.max())} "
              f"(tolerance {tol})")
        del got, diff
    # bytes: read x and ids, write out (+ the table); operations: what this
    # run's ids need, where in residual mode only the groups with rscale > 0
    # have an output (elsewhere out = x) and in pred mode every group has
    live = [g for g in range(G) if mode == "pred" or float(model.rscale[g]) > 0]
    flop, h_per_px = enhancer_flop(n, ids, live, C)
    row("enhancer_fused", lambda: enhancer_fused.enhancer_grouped(xs, ids, packed, mode=mode),
        lambda: ref.enhancer_grouped_ref(xs, ids, packed, mode=mode),
        12 * n + 4 * packed.numel(), flop, reps=10, plain_reps=1, timer=launch_events_ms)
    launch = "the enhanced full decode's" if mode == "residual" else "the gate's"
    rows["enhancer_fused"]["shape_note"] = (
        f"x/ids {list(xs.shape)}, G={G}, C={C}, {len(live)} groups with an output, "
        f"{filled} holding values, {mode} ({launch} launch); {h_per_px:.4f} hidden values "
        f"needed per pixel")
    rows["enhancer_fused"]["flop"] = flop
    if not with_g1:
        return rows
    del ids
    # the TPU kernel's own contract, G = 1, on the same slices scaled to
    # [0, 1] (its inputs are normalised); its library yardstick is one cuDNN
    # conv -> affine -> relu -> conv in float32
    xs = ((xs - xs.min()) / (xs.max() - xs.min())).contiguous()
    p1 = {k: v[0] for k, v in model.params.items()}
    s1 = {k: v[0] for k, v in model.bn_state.items()}
    single = enhancer_fused.single_enhancer(p1["w1"], p1["b1"], p1["gamma"], p1["beta"],
                                            s1["mean"], s1["var"], p1["w2"], p1["b2"])
    par.compare_float("enhancer_fused", "G1_gwlz_slices",
                      enhancer_fused.enhancer_grouped(xs, None, single, mode="pred"),
                      ref.enhancer_fused_ref(xs, p1["w1"], p1["b1"], p1["gamma"], p1["beta"],
                                             s1["mean"], s1["var"], p1["w2"], p1["b2"]),
                      ENHANCE_RTOL)
    bn_scale, bn_shift = enhancer_fused.fold_bn(p1["gamma"], p1["beta"], s1["mean"],
                                                s1["var"])
    wc1 = p1["w1"].permute(3, 2, 0, 1).contiguous()  # [C, 1, 3, 3]
    wc2 = p1["w2"].permute(3, 2, 0, 1).contiguous()  # [1, C, 3, 3]

    def library_g1():
        import torch.nn.functional as F

        with enhancer.fp32_convs():
            h = F.conv2d(xs[:, None], wc1, p1["b1"], padding=1)
            h = torch.relu(h * bn_scale[None, :, None, None] + bn_shift[None, :, None, None])
            return F.conv2d(h, wc2, p1["b2"], padding=1)[:, 0]

    g1_ms, g1_by = launch_events_ms(lambda: enhancer_fused.enhancer_grouped(
        xs, None, single, mode="pred"), 10)
    g1_flop, _ = enhancer_flop(n, None, [0], C)
    rows["enhancer_fused"]["g1"] = {
        "shape": f"x {list(xs.shape)}, G=1, C={C}", "ms": g1_ms, "ms_by": g1_by,
        "plain_ms": events_ms(lambda: ref.enhancer_fused_ref(
            xs, p1["w1"], p1["b1"], p1["gamma"], p1["beta"], s1["mean"], s1["var"],
            p1["w2"], p1["b2"]), 1),
        "library_ms": events_ms(library_g1, 10),
        "bound_ms": max(8 * n / HBM_BYTES_PER_S, g1_flop / FP32_OPS_PER_S) * 1e3,
        "bound_by": "operations" if g1_flop / FP32_OPS_PER_S > 8 * n / HBM_BYTES_PER_S
        else "bytes", "flop": g1_flop}
    return rows


def kernel_rows(par: Parity, x_np, art, path_launches: dict, gw: dict, sz_art,
                mono) -> list[dict]:
    """Parity and timing of each kernel on its path's own shapes
    (``path_launches``: path -> launches of its run); the enhancer's
    kernels on both gwlz runs (``gw``: phase -> (art, model, launches)), the
    second as each row's ``all_groups``; lorenzo_quant on the szjx path
    (``sz_art``), and huffman_decode and enhancer_fused also at the
    monolithic shapes (``mono``: the gwlz_mono (art, model, launches))."""
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

    row = functools.partial(time_row, rows)

    codes = lorenzo_quant.lorenzo_quant_tiles(tiles, eb)
    par.compare("lorenzo_quant_tiles", "main_512x64^3", codes,
                ref.lorenzo_quant_tiles_ref(tiles, eb))
    n = tiles.numel()
    # bytes: read x, write codes; operations: 1 division + 7 adds per element
    row("lorenzo_quant_tiles", lambda: lorenzo_quant.lorenzo_quant_tiles(tiles, eb),
        lambda: ref.lorenzo_quant_tiles_ref(tiles, eb), 8 * n, 8 * n, reps=20, plain_reps=5)
    rows["lorenzo_quant_tiles"]["shape_note"] = f"x {list(tiles.shape)} f32"

    vcodes = lorenzo_quant.lorenzo_quant(x, eb)
    par.compare("lorenzo_quant", "szjx_512^3", vcodes, ref.lorenzo_quant_ref(x, eb))
    del vcodes
    n = x.numel()
    # bytes: read x, write codes; operations: 1 division + 7 adds per element
    row("lorenzo_quant", lambda: lorenzo_quant.lorenzo_quant(x, eb),
        lambda: ref.lorenzo_quant_ref(x, eb), 8 * n, 8 * n, reps=20, plain_reps=5)
    rows["lorenzo_quant"]["shape_note"] = f"x {list(x.shape)} f32, whole volume"

    # the one whole-volume stream of the szjx path: one launch each over
    # every symbol / chunk (``mono``)
    mrows = {}
    vflat = lorenzo_quant.lorenzo_quant(x, eb).reshape(-1)
    lo, hi = torch.stack(torch.aminmax(vflat)).tolist()
    vshift, vspan = vflat - lo, hi - lo + 1
    par.compare("symbol_hist", "szjx_stream", group_hist.symbol_hist(vshift, vspan),
                ref.symbol_hist_ref(vshift, vspan))
    vshift64 = vshift.to(torch.int64)
    time_row(mrows, "symbol_hist", lambda: group_hist.symbol_hist(vshift, vspan),
             lambda: ref.symbol_hist_ref(vshift, vspan), 4 * vshift.numel() + 4 * vspan,
             vshift.numel(), library=lambda: torch.bincount(vshift64, minlength=vspan),
             reps=20, plain_reps=2)
    mrows["symbol_hist"]["shape_note"] = f"{vshift.numel()} symbols, {vspan} bins, one stream"
    del vshift, vshift64
    vcodec = entropy.HuffmanCodec.fit(vflat)
    vl, vc = vcodec._pack_inputs(vflat, entropy.DEFAULT_CHUNK)
    del vflat
    par.compare("huffman_encode", "szjx_stream", huffman_encode.huffman_encode_pack(vl, vc),
                ref.huffman_encode_ref(vl, vc))
    vC, vcs = vl.shape
    time_row(mrows, "huffman_encode", lambda: huffman_encode.huffman_encode_pack(vl, vc),
             lambda: ref.huffman_encode_ref(vl, vc), 12 * vC * vcs + 4 * vC, 12 * vC * vcs,
             reps=20, plain_reps=1)
    mrows["huffman_encode"]["shape_note"] = f"lens/codes [{vC}, {vcs}] i32, one stream"
    del vl, vc

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
    del args, ids

    dcodec, n_sym, dcs, chunk_bits, stream, _ = entropy.parse_chunked(sz_art.code_blob)
    cb = np.asarray(chunk_bits, np.int64)
    args, kw = dcodec._decode_inputs(stream, n_sym, dcs, np.cumsum(cb) - cb, dev)
    ids = huffman_decode.huffman_decode_probe(*args, **kw)
    par.compare("huffman_decode", "szjx_stream", ids, ref.huffman_decode_ref(*args, **kw))
    n_words = -(-int(cb.sum()) // 32)
    nbytes = 4 * (n_words + args[1].numel() + args[2].numel() + ids.numel())
    time_row(mrows, "huffman_decode", lambda: huffman_decode.huffman_decode_probe(*args, **kw),
             lambda: ref.huffman_decode_ref(*args, **kw), nbytes, 16 * n_sym, reps=20,
             plain_reps=1)
    mrows["huffman_decode"]["shape_note"] = (f"{args[0].numel()} stream words, ids "
                                             f"[{ids.shape[0]}, {ids.shape[1]}], one stream")
    del args, ids

    gw_art, model, gw_launches = gw["gwlz"]
    rows.update(gwlz_kernel_rows(par, tile_slices(gw_art), model, "gwlz", "residual",
                                 with_g1=True))
    all_art, all_model, all_launches = gw["gwlz_all_groups"]
    all_rows = gwlz_kernel_rows(par, tile_slices(all_art), all_model, "gwlz_all_groups",
                                "pred", with_g1=False)
    mono_art, mono_model, mono_launches = mono
    from repro_torch.sz import SZCompressor

    mono_xs = SZCompressor("lorenzo").decompress(mono_art)  # 512 slices of 512x512
    mrows.update(gwlz_kernel_rows(par, mono_xs, mono_model, "gwlz_mono", "residual",
                                  with_g1=False))
    del mono_xs

    out = []
    for name, (source, replaces, _) in KERNELS.items():
        r = rows[name]
        if name in GWLZ_KERNELS:
            a = all_rows[name]
            r["all_groups"] = {"launches": all_launches[name], "shape": a.pop("shape_note"),
                               **a}
        if name in mrows:
            m = mrows[name]
            r["mono"] = {"launches": (mono_launches if name in GWLZ_KERNELS
                                      else path_launches["szjx"])[name],
                         "shape": m.pop("shape_note"), **m}
        path = LAUNCH_PATH[name]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": path_launches[path][name], "max_abs_err": par.err[name],
                    "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "ms_by": r["ms_by"], "call_ms": r["call_ms"], "shape": r["shape_note"],
                    "launches_path": path,
                    "launches_by_path": {p: ls[name] for p, ls in path_launches.items()},
                    **({"tolerance": par.tol[name]} if par.tol[name] else {}),
                    **{k: r[k] for k in ("flop", "g1", "all_groups", "mono") if k in r}})
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

    from repro_torch.sz import SZCompressed, decompress

    gold = ROOT / "tests" / "golden"
    for name, parse, decode in (("gwtc_v1", TiledCompressed.from_bytes, decompress_tiled),
                                ("szjx_lorenzo", SZCompressed.from_bytes, decompress)):
        got = decode(parse((gold / f"{name}.bin").read_bytes())).cpu().numpy()
        want = np.load(gold / f"{name}_decode.npy")
        check(got.shape == want.shape and np.array_equal(got.view(np.uint32),
                                                         want.view(np.uint32)),
              f"{name}.bin does not decode bit-exact")
    emit({"phase": "golden", "files": ["tests/golden/gwtc_v1.bin",
                                       "tests/golden/szjx_lorenzo.bin"], "bit_exact": True})


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
    emit({"phase": "field", "field": "temperature", "shape": list(SHAPE),
          "seconds": time.perf_counter() - t0})

    art, blob, launches = main_path(x_np)
    del blob
    gw = {"gwlz": gwlz_path(x_np, "gwlz")}
    t0 = time.perf_counter()
    vx = nyx_like_field(SHAPE, GWLZ_FIELDS["gwlz_all_groups"], seed=0)
    emit({"phase": "field", "field": GWLZ_FIELDS["gwlz_all_groups"], "shape": list(SHAPE),
          "seconds": time.perf_counter() - t0})
    gw["gwlz_all_groups"] = gwlz_path(vx, "gwlz_all_groups")
    del vx
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sz_art, sz_launches = szjx_path(x_np, Path(tmp))
        mono = gwlz_mono_path(x_np, Path(tmp))
        cli_path(Path(tmp))
    path_launches = {"main": launches, "gwlz": gw["gwlz"][2], "szjx": sz_launches,
                     "gwlz_mono": mono[2]}
    with torch.no_grad():  # the model's parameters must not build autograd graphs here
        rows = kernel_rows(par, x_np, art, path_launches, gw, sz_art, mono)
    cpu_vs_card(x_np)
    golden()

    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
