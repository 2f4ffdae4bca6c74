#!/usr/bin/env python3
"""Controls of the out-of-core cells' checks (``stream_loop``,
``region_loop``): each puts a wrong answer where the program's is, and the
check has to call the run not correct.

* ``bf16``: the reference's decode in bfloat16 stands in for what the
  program gave (``perfbench/control.py``'s stand-in: for ``stream-write``
  the field the file decodes to, for ``gwlz-region`` each kept box);
* ``reservoir_seed`` (write): the program's reservoir drawn from another
  seed (its ``TileReservoir`` seeded one higher);
* ``code`` (write): one code altered before entropy coding;
* ``shift`` (region): each kept box read one voxel off along the first axis.

    python3 perfbench/control_out_of_core.py --workload stream-write --control code --seeds 1,2,3 --seconds 5

prints one JSON line a seed with the numbers the check compared.  The
benchmark's own runs never run this file; ``perfbench/tests`` runs the same
functions at a small size on the CPU.
"""
from __future__ import annotations

import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import control as C  # noqa: E402
from perfbench import harness as H  # noqa: E402


def _alter_first(t: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    t.view(-1)[0] += 1
    return t


# faults planted in the program: (module, attribute, wrapper)
FAULTS = {
    "reservoir_seed": ("repro_torch.core.trainer", "TileReservoir",
                       lambda cls: lambda capacity, seed=0: cls(capacity, seed=seed + 1)),
    "code": ("repro_torch.sz.entropy", "encode_codes_lanes",
             lambda f: lambda codes, *a, **k: f(_alter_first(codes), *a, **k)),
}
CONTROLS = ("bf16", "shift", *FAULTS)


def plant(fault: str):
    """Plant a fault; returns the function that removes it."""
    mod_name, attr, wrap = FAULTS[fault]
    mod = importlib.import_module(mod_name)
    saved = getattr(mod, attr)
    setattr(mod, attr, wrap(saved))
    return lambda: setattr(mod, attr, saved)


def shifted_outputs(run) -> None:
    """Replace each kept box's output by the program's read of the box one
    voxel off along the first axis (up where it fits, else down)."""
    vol, dim = run.state["vol"], run.cfg["shape"][0]
    for i, ((a, b), *rest) in run.state["boxes"].items():
        d = 1 if b < dim else -1
        key = (slice(a + d, b + d), *(slice(lo, hi) for lo, hi in rest))
        run.state["kept"][i] = np.asarray(vol[key])


def control_run(bench: dict, cell: str, control: str, seed: int, seconds: float,
                device: str, overrides: dict | None = None) -> dict:
    """Set-up, a short window and the check, with the control in place."""
    if control == "bf16":
        return {**C.control_run(bench, cell, seed, seconds, device, overrides),
                "control": control}
    run, kind = H.prepare(bench, cell, seed, seconds, False, device, overrides)
    run.api = H.import_program()
    t0 = time.perf_counter()
    unplant = plant(control) if control in FAULTS else None
    try:
        kind.setup(run)
        kind.window(run)
    finally:
        if unplant:
            unplant()
    if control == "shift":
        shifted_outputs(run)
    kind.release(run)
    checks = kind.check(run)
    return {"cell": cell, "control": control, "seed": seed, "ops": len(run.records),
            "correct": all(H.passes(c) for c in checks), "checks": H.check_lines(checks),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control", required=True, choices=CONTROLS)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = H.load_json(H.ROOT / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_run(bench, args.workload, args.control, seed, args.seconds,
                                     "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
