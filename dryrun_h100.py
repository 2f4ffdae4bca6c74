#!/usr/bin/env python3
"""The dry run of every cell on the production H100 mesh, one cell a
subprocess under a time limit, then the roofline table.

    python3 dryrun_h100.py [--mesh single|multi|both] [--jobs N]
        [--cell-timeout S] [--cells ARCH:SHAPE,...] [--out DIR]

Each cell is ``python -m repro_torch.launch.dryrun --arch A --shape S
--mesh M --out DIR`` (gwlz-nyx: its one cell); ``--jobs`` run at once.  A
cell still tracing after ``--cell-timeout`` seconds is killed and written
as an error row ("too slow to trace", with the seconds it ran), so no cell
drops out of the table unnoticed.  Then ``python -m
repro_torch.launch.roofline --dir DIR --mesh all`` prints the table.  It
prints the card's name and power limit first; the trace itself is shapes
only, so the card is not needed, and the mesh is a CUDA one where a card
is present.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def all_cells() -> list[tuple[str, str]]:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.shapes import SHAPES

    return [("gwlz-nyx", "vol512_g32")] + [(a, s) for a in ARCH_IDS for s in SHAPES]


def run_cell(arch: str, shape: str, mesh: str, out: Path, timeout: float) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
           shape, "--mesh", mesh, "--out", str(out)]
    t = time.perf_counter()
    try:
        r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        s = time.perf_counter() - t
        for tag in (["single", "multi"] if mesh == "both" else [mesh]):
            if (out / f"{arch}_{shape}_{tag}.json").exists():
                continue  # traced before the limit
            with open(out / f"{arch}_{shape}_{tag}.json", "w") as f:
                json.dump({"arch": arch, "shape": shape, "mesh": tag,
                           "error": f"too slow to trace: still tracing after {s:.0f} s",
                           "trace_s_at_least": s}, f, indent=1)
        return f"TIMEOUT {arch} {shape} after {s:.0f} s"
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith(("OK", "FAIL", "SKIP"))]
    tail = "" if r.returncode == 0 else r.stderr[-400:]
    return f"exit {r.returncode} {arch} {shape} {time.perf_counter() - t:.1f} s: " \
           + " | ".join(lines) + tail


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--cell-timeout", type=float, default=600.0)
    ap.add_argument("--cells", default="", help="ARCH:SHAPE,... (default: every cell)")
    ap.add_argument("--out", default=str(ROOT / "experiments" / "dryrun_h100"))
    args = ap.parse_args()
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "no nvidia-smi"
    print(f"card: {smi}", flush=True)
    cells = ([tuple(c.split(":")) for c in args.cells.split(",")] if args.cells
             else all_cells())
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        futures = [pool.submit(run_cell, a, s, args.mesh, out, args.cell_timeout)
                   for a, s in cells]
        for f in futures:
            print(f.result(), flush=True)
    print(f"sweep {time.perf_counter() - t0:.1f} s", flush=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--dir", str(out),
                        "--mesh", "all", "--json-out", str(out / "roofline.json")], env=env,
                       capture_output=True, text=True, timeout=600)
    print(r.stdout, r.stderr[-2000:], flush=True)
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
