"""Pieces the traffic kinds share: the fields, the closed loop of one
client, and the numbers the check compares."""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import trace as T
from perfbench.reference import nyx


def field(run, seed: int) -> torch.Tensor:
    """The configuration's field from ``seed``, on the device."""
    return nyx.field(run.cfg["shape"], run.cfg["field"], seed, run.device)


def closed_loop(run, op, cycle: int = 1) -> None:
    """One client: ``op(i)`` after ``op(i - 1)`` returns, in whole cycles
    of ``cycle`` ops, for every cycle that starts inside the window; ``op``
    returns the op's record (a dict), to which the loop adds its start and
    end.  In a traced run op 0 runs under the device profiler and every
    later op records the seconds of the run's spans (``spans.py``) it ran;
    the window runs on until op 1 is done."""
    run.t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        over = t0 - run.t_start >= run.seconds and i % cycle == 0
        if over and (not run.trace or i >= 2):
            break
        before = {k: s.seconds for k, s in run.spans.items()}
        if run.trace and i == 0:
            with T.device_profile(run.device) as tr:
                rec = op(i)
                run.sync()
            run.dev_trace = tr
        else:
            rec = op(i)
            run.sync()
        rec.update(t0=t0, t1=time.perf_counter(), i=i,
                   spans={k: s.seconds - before[k] for k, s in run.spans.items()})
        run.records.append(rec)
        i += 1


def sample(run, n_items: int, k: int, salt: int) -> list[int]:
    """``k`` of ``n_items`` indices drawn from the run's seed (sorted)."""
    rng = np.random.default_rng([run.seed, salt])
    return sorted(rng.choice(n_items, size=min(k, n_items), replace=False).tolist())


def err_limit(cfg: dict, eb: float, amax: float) -> float:
    """The configuration's error guarantee in units of eb: ``|x - x'| <=
    float32(eb) + ulps * 2**-23 * max|x|``."""
    return (float(np.float32(eb)) + cfg["guarantee_ulps"] * 2.0 ** -23 * amax) / eb


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float32) - b.to(torch.float32)).abs().max())


def mse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a.double() - b.double()) ** 2).mean())
