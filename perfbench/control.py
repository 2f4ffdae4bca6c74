#!/usr/bin/env python3
"""The control of the correctness check: a lower precision in the
program's place, which the check has to call not correct.

* Read cells (``read_loop``): the reference's decode computed in bfloat16
  (the precision below the configuration's float32) stands in for every
  output the program gave.
* Write cells (``write_loop``): what a write produces is the field its
  container decodes to; the reference's bfloat16 decode of the program's
  containers stands in for that float32 reconstruction.  With enhancers,
  the reference's first training steps in bfloat16 stand in for the
  program's.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 --seconds 5

prints one JSON line a seed with the numbers the check compared.

    python3 perfbench/control.py --workload gwlz-write --seeds 1,2,3 --train [--fault F]

compresses the field of each seed once with the configuration's codec
call and prints the training numbers (``reference.trainer.gaps``) of the
program's first steps against the reference's: the sound readings and the
bfloat16 control's, or, with ``--fault``, those of the program with one of
``TRAIN_FAULTS`` planted.  The benchmark's own runs never run this file.
``perfbench/tests`` runs the same functions at a small size on the CPU.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness as H  # noqa: E402
from perfbench import loop as L  # noqa: E402
from perfbench import reference as R  # noqa: E402
from perfbench.reference import predictors as P  # noqa: E402
from perfbench.reference import trainer as T  # noqa: E402
from perfbench.spans import TrainProbe  # noqa: E402

LOW = torch.bfloat16


def _half_batch(f):
    """Half of each training batch left out, the mean taken over the rest."""
    def step(enh, opt_state, xb, rb, idsb, *args, **kwargs):
        h = max(xb.shape[0] // 2, 1)
        return f(enh, opt_state, xb[:h], rb[:h], idsb[:h], *args, **kwargs)
    return step


def _no_bias_correction(f):
    """Adam without its bias correction (1 - b ** step read as 1)."""
    def update(params, state, *args, **kwargs):
        n = int(state["step"])
        state["step"] = 10 ** 6
        try:
            f(params, state, *args, **kwargs)
        finally:
            state["step"] = n + 1
    return update


# faults planted in the program's training: (module, attribute, wrapper)
TRAIN_FAULTS = {
    "half_batch": ("repro_torch.core.trainer", "train_step", _half_batch),
    "no_bias_correction": ("repro_torch.optim.adamw", "update", _no_bias_correction),
}


def plant(fault: str):
    """Plant a training fault; returns the function that removes it."""
    import importlib

    mod_name, attr, wrap = TRAIN_FAULTS[fault]
    mod = importlib.import_module(mod_name)
    saved = getattr(mod, attr)
    setattr(mod, attr, wrap(saved))
    return lambda: setattr(mod, attr, saved)


def low_precision_outputs(run) -> None:
    """Replace every output the program gave in a read cell by the
    reference's bfloat16 decode of the same container."""
    d = R.decode(run.state["blob"], run.device, dtype=LOW)
    out = d.out.cpu().numpy()
    for k in run.state["kept"]:
        run.state["kept"][k] = out


def control_run(bench: dict, cell: str, seed: int, seconds: float, device: str,
                overrides: dict | None = None) -> dict:
    """Set-up, a short window and the check, with the control in place."""
    run, kind = H.prepare(bench, cell, seed, seconds, False, device, overrides)
    run.api = H.import_program()
    t0 = time.perf_counter()
    kind.setup(run)
    kind.window(run)
    if run.mix["kind"] == "write_loop":
        run.state["decode_dtype"] = LOW
        if run.cfg.get("enhance"):
            run.state["train_dtype"] = LOW
    else:
        low_precision_outputs(run)
    kind.release(run)
    checks = kind.check(run)
    return {"cell": cell, "seed": seed, "ops": len(run.records),
            "correct": all(H.passes(c) for c in checks), "checks": H.check_lines(checks),
            "seconds": time.perf_counter() - t0}


def training_readings(bench: dict, cell: str, seeds, device, fault: str | None = None,
                      overrides: dict | None = None):
    """For each seed, one compress of that seed's field with the probe on;
    yields the training numbers of the program's first steps against the
    reference's (``sound``, or ``fault``) and, without a fault, those of
    the reference in bfloat16 (``control``)."""
    run, kind = H.prepare(bench, cell, seeds[0], 0.0, False, device, overrides)
    run.api = H.import_program()
    cfg = run.cfg
    probe = TrainProbe(cfg["adam"]["b1"]).install()
    unplant = plant(fault) if fault else None
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            x = L.field(run, seed)
            blob, _ = kind._compress(run, x)
            prog = probe.take()
            probe.trainings.clear()
            d = R.decode(blob, device, enhance=False)
            sz_t, x_t = P.split_tiles(d.sz, cfg["tile"]), P.split_tiles(x, cfg["tile"])
            del d
            ref = T.first_steps(sz_t, x_t, cfg["enhance"], cfg["adam"])
            out = {"cell": cell, "seed": seed, "fault": fault}
            out["fault" if fault else "sound"] = (T.gaps(prog, ref) if prog else
                                                  dict.fromkeys(T.NUMBERS, float("nan")))
            if not fault:
                low = T.first_steps(sz_t, x_t, cfg["enhance"], cfg["adam"], dtype=LOW)
                out["control"] = T.gaps(low, ref)
            out["seconds"] = time.perf_counter() - t0
            del x, sz_t, x_t
            yield out
    finally:
        probe.remove()
        if unplant:
            unplant()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--train", action="store_true")
    p.add_argument("--fault", choices=sorted(TRAIN_FAULTS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = H.load_json(H.ROOT / "BENCHMARK.json")
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.train:
        for out in training_readings(bench, args.workload, seeds, "cuda", args.fault):
            print(json.dumps(out), flush=True)
        return 0
    for seed in seeds:
        print(json.dumps(control_run(bench, args.workload, seed, args.seconds, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
