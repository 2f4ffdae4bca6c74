"""Spans the benchmark places around calls into one layer of the program:
the call is wrapped for the run, and the wrapper adds its host-clock
seconds to a total.  Nothing in the program changes; the wrapper costs two
clock reads a call."""
from __future__ import annotations

import importlib
import threading
import time


class Span:
    """Seconds and calls spent inside ``module.attr`` (``attr`` may be
    ``Class.method``) while installed."""

    def __init__(self, module: str, attr: str):
        self.module, self.attr = module, attr
        self.seconds = 0.0
        self.calls = 0
        self._lock = threading.Lock()
        self._saved = None

    def _owner(self):
        owner = importlib.import_module(self.module)
        *path, name = self.attr.split(".")
        for p in path:
            owner = getattr(owner, p)
        return owner, name

    def install(self) -> "Span":
        owner, name = self._owner()
        inner = self._saved = getattr(owner, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.seconds += dt
                    self.calls += 1

        setattr(owner, name, timed)
        return self

    def remove(self) -> None:
        owner, name = self._owner()
        setattr(owner, name, self._saved)


class TrainProbe:
    """The first steps of every enhancer training the program runs, read
    from the arguments of ``repro_torch.core.trainer.train_step(enh,
    opt_state, ...)``: the weights it starts from, the loss of each of the
    first ``steps`` steps, the first gradient as the optimizer holds it
    (Adam's first moment after one step over ``1 - b1``) and the weights
    after ``steps`` steps, as the next step receives them.  One record a
    training, in ``trainings``; a few copies of the ~4k weights a training,
    nothing a step after the first ``steps + 1``."""

    MODULE, ATTR = "repro_torch.core.trainer", "train_step"

    def __init__(self, b1: float, steps: int = 3):
        self.b1, self.steps = b1, steps
        self.trainings: list[dict] = []
        self._saved = None

    def install(self) -> "TrainProbe":
        owner = importlib.import_module(self.MODULE)
        inner = self._saved = getattr(owner, self.ATTR)

        def probed(enh, opt_state, *args, **kwargs):
            step = int(opt_state["step"])
            if step > self.steps:
                return inner(enh, opt_state, *args, **kwargs)
            if step == 0:
                self.trainings.append({"init": _copy(enh.params()), "loss": []})
            rec = self.trainings[-1]
            if step == self.steps:
                rec["params"] = _copy(enh.params())
                return inner(enh, opt_state, *args, **kwargs)
            losses = inner(enh, opt_state, *args, **kwargs)
            rec["loss"].append(losses.detach().sum().clone())
            if step == 0:
                rec["grad"] = {k: v.detach().float() / (1 - self.b1)
                               for k, v in opt_state["m"].items()}
            return losses

        setattr(owner, self.ATTR, probed)
        return self

    def remove(self) -> None:
        setattr(importlib.import_module(self.MODULE), self.ATTR, self._saved)

    def take(self) -> dict | None:
        """The newest training's record, with host floats for the losses
        (None when no training reached ``steps + 1`` steps)."""
        if not self.trainings or "params" not in self.trainings[-1]:
            return None
        rec = self.trainings[-1]
        return {**rec, "loss": [float(v) for v in rec["loss"]]}


def _copy(params: dict) -> dict:
    return {k: v.detach().float().clone() for k, v in params.items()}
