#!/usr/bin/env python3
"""Where the port's main-path time goes on one CUDA card.

    python3 profile_port.py          # from the repository root, after chip_smoke.py

On the main-path cell of ``chip_smoke.py`` (nyx_like_field((512,)*3,
"temperature", seed=0), tile 64^3, rel_eb 1e-3, huffman+zlib) it prints JSON
lines with:

* ``repeats``: compress / decompress seconds of four runs in a row, so the
  spread of the host clock shows;
* ``host``: the host functions with the most own time (cProfile) in one
  compress and one decompress;
* ``device``: CUDA time per kernel and the device's busy share of the wall
  time (torch.profiler) over one compress and one decompress.
"""
from __future__ import annotations

import cProfile
import json
import pstats
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

SHAPE, TILE, REL_EB = (512, 512, 512), (64, 64, 64), 1e-3


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.data import nyx_like_field
    from repro_torch.sz import compress_tiled, decompress_tiled

    x = nyx_like_field(SHAPE, "temperature", seed=0)
    compress = lambda: compress_tiled(x, TILE, rel_eb=REL_EB)[0]  # noqa: E731
    art = compress()  # warm-up: library load, allocator

    runs = []
    for _ in range(4):
        _, c_s = timed(compress)
        _, d_s = timed(lambda: decompress_tiled(art))
        runs.append({"compress_s": c_s, "decompress_s": d_s})
    print(json.dumps({"repeats": runs}), flush=True)

    for name, fn in (("compress", compress), ("decompress", lambda: decompress_tiled(art))):
        prof = cProfile.Profile()
        prof.enable()
        _, wall = timed(fn)
        prof.disable()
        stats = pstats.Stats(prof).stats
        top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:8]
        print(json.dumps({"host": name, "wall_s": wall, "top_own_s": [
            {"fn": f"{Path(k[0]).name}:{k[1]}({k[2]})", "own_s": v[2], "calls": v[1]}
            for k, v in top]}), flush=True)

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as p:
            _, wall = timed(fn)
        # device-side events only (kernels, memcpy, memset): the host ops that
        # launched them report the same time again
        dev = {e.key: e.self_device_time_total / 1e3 for e in p.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0}
        busy_ms = sum(dev.values())
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
        print(json.dumps({"device": name, "wall_s": wall,
                          "busy_ms": busy_ms if dev else "not measured",
                          "busy_share": busy_ms / (wall * 1e3) if dev else "not measured",
                          "top_ms": dict(top)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
