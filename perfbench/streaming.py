"""Pieces the out-of-core cells share: the configuration's streaming call,
the directory its files go to, and a probe that keeps the reservoir the
program trained on.

The files of a run go to a fresh directory under the checkout's
``build/perfbench_io`` (local disk, as the deployment's), which the
traffic's ``release`` removes.
"""
from __future__ import annotations

import importlib
import os
import shutil
import tempfile

from perfbench.harness import ROOT


def stream_kwargs(run) -> dict:
    """The codec call of the configuration, as ``api.compress_stream`` takes it."""
    from repro_torch.core.trainer import GWLZTrainConfig

    c = run.cfg
    kw = dict(eb=c["rel_eb"], tile=tuple(c["tile"]), mem_budget=c["mem_budget"],
              predictor=c["predictor"], backend=c["backend"], device=run.device)
    if c.get("enhance"):
        kw["enhance"] = GWLZTrainConfig(**c["enhance"], epochs=c["epochs"])
    return kw


def io_dir(run) -> str:
    if "io_dir" not in run.state:
        base = ROOT / "build" / "perfbench_io"
        base.mkdir(parents=True, exist_ok=True)
        run.state["io_dir"] = tempfile.mkdtemp(prefix=f"{run.cell}-", dir=base)
    return run.state["io_dir"]


def remove_io_dir(run) -> None:
    d = run.state.pop("io_dir", None)
    if d is not None:
        shutil.rmtree(d, ignore_errors=True)


def stream_file(run, x, path: str) -> tuple[dict, bytes]:
    """Stream the host array ``x`` into ``path`` with the configuration's
    call; returns the op's record and the finished file's bytes.  The
    record says whether a commit journal survived the finished op."""
    rep = run.api.compress_stream(x, path, **stream_kwargs(run))
    journal = os.path.exists(path + ".journal")
    with open(path, "rb") as f:
        blob = f.read()
    rec = {"raw": int(x.nbytes), "out": len(blob), "journal_left": int(journal),
           "n_batches": rep.n_batches, "batch_tiles": rep.batch_tiles,
           "reservoir_tiles": rep.reservoir_tiles, "peak_tracked_bytes": rep.peak_tracked_bytes,
           "host_stage_s": rep.host_stage_s, "entropy_device": rep.entropy_device,
           "retries": rep.retries}
    return rec, blob


class ReservoirProbe:
    """The reservoir of every streamed training, read from the first
    argument of ``repro_torch.core.trainer.train_enhancers_streamed(reservoir,
    cfg, ...)``: the object itself is kept (no copy), one a training, in
    ``reservoirs``."""

    MODULE, ATTR = "repro_torch.core.trainer", "train_enhancers_streamed"

    def __init__(self):
        self.reservoirs: list = []
        self._saved = None

    def install(self) -> "ReservoirProbe":
        owner = importlib.import_module(self.MODULE)
        inner = self._saved = getattr(owner, self.ATTR)

        def probed(reservoir, *args, **kwargs):
            self.reservoirs.append(reservoir)
            return inner(reservoir, *args, **kwargs)

        setattr(owner, self.ATTR, probed)
        return self

    def remove(self) -> None:
        setattr(importlib.import_module(self.MODULE), self.ATTR, self._saved)

    def take(self):
        """The newest training's reservoir (None where none trained)."""
        got = self.reservoirs[-1] if self.reservoirs else None
        self.reservoirs.clear()
        return got
