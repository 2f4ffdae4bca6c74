"""The benchmark harness: finds a cell's configuration, traffic and metric
readers by name, runs set-up, the measured window and the check against
the plain reference, and prints the result line.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own under ``perfbench/``:

* ``configs/<config>.json``: the deployment (field, shape, codec call,
  precision, the guarantee and the limits of the check);
* ``workloads/<traffic>.json``: a traffic mix, the parameters of one
  general generator ``traffic/<kind>.py`` (``setup``, ``window``,
  ``release``, ``check``);
* ``readers/<metric>.py``: ``read(run)`` returns the metric or None; a
  reader may name ``SPANS``, program calls ``(module, attr)`` that a traced
  run times (``spans.py``).

A new cell, mix or metric is a new file and a new entry in
``BENCHMARK.json``; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from perfbench.spans import Span

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names


class BenchError(RuntimeError):
    """The run cannot give a result (no card, no program, a loaded JAX)."""


def _load(path: Path, name: str):
    if not path.is_file():
        raise BenchError(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def import_program():
    """The program under test, from this checkout's ``src``: its façade."""
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise BenchError("the program (src/repro_torch) is not in this checkout")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    from repro_torch import api

    if not Path(api.__file__).resolve().is_relative_to(src.resolve()):
        raise BenchError(f"repro_torch loaded from {api.__file__}, outside this checkout")
    return api


@dataclass
class Run:
    """One run of one cell: its inputs, and what the traffic and the check
    leave for the readers."""

    cell: str
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    api: object = None
    setup_s: float = 0.0
    t_start: float = 0.0  # the window's start (host clock)
    records: list = field(default_factory=list)  # one dict an op
    failed: int = 0
    dev_trace: object = None  # trace.DeviceTrace of the profiled part
    spans: dict = field(default_factory=dict)  # "module:attr" -> spans.Span, traced runs
    state: dict = field(default_factory=dict)  # the traffic's own

    def sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    def compress_kwargs(self) -> dict:
        """The codec call of the configuration, as ``api.compress`` takes it."""
        from repro_torch.core.trainer import GWLZTrainConfig

        c = self.cfg
        kw = dict(eb=c["rel_eb"], tiled=True, tile=tuple(c["tile"]), predictor=c["predictor"],
                  backend=c["backend"], device=self.device)
        if c["predictor"] == "interp":
            kw["order"] = c["order"]
        if c.get("enhance"):
            kw["enhance"] = GWLZTrainConfig(**c["enhance"], epochs=c["epochs"])
        return kw


def find_cell(bench: dict, cell: str):
    for w in bench["workloads"]:
        if w["name"] == cell:
            cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
            return w, cfg
    raise BenchError(f"no workload {cell!r} in BENCHMARK.json")


def prepare(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device: str,
            overrides: dict | None = None) -> tuple[Run, object]:
    w, centry = find_cell(bench, cell)
    overrides = overrides or {}
    cfg = {**load_json(ROOT / centry["file"]), **overrides.get("cfg", {})}
    mix = {**load_json(HERE / "workloads" / f"{w['traffic']}.json"), **overrides.get("mix", {})}
    kind = _load(HERE / "traffic" / f"{mix['kind']}.py", f"perfbench_traffic_{mix['kind']}")
    run = Run(cell, cfg, mix, seed, seconds, trace, device)
    return run, kind


def execute(bench: dict, run: Run, kind, t_begin: float) -> dict:
    """Set-up, window, check and readers; returns the result line (a dict)."""
    import torch

    run.api = import_program()
    kind.setup(run)
    run.sync()
    run.setup_s = time.perf_counter() - t_begin
    metrics_def = [m for m in (bench["per_layer"] if run.trace else bench["end_to_end"])
                   if applies(m, run.cell)]
    readers = {m["name"]: _load(HERE / "readers" / f"{m['name']}.py",
                                "perfbench_reader_" + m["name"].replace(".", "_"))
               for m in metrics_def}
    if run.trace:  # the spans the cell's per-layer readers read
        for r in readers.values():
            for module, attr in getattr(r, "SPANS", ()):
                key = f"{module}:{attr}"
                if key not in run.spans:
                    run.spans[key] = Span(module, attr).install()
    try:
        kind.window(run)
        run.sync()
    finally:
        for s in run.spans.values():
            s.remove()
    on_card = run.device != "cpu"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind.release(run)
    # [(name, value, limit[, ">="])], value <= limit to pass; an op that
    # failed gave no answer, so it fails the run
    checks = kind.check(run) + [("ops_failed", run.failed, 0)]
    metrics = {}
    for m in metrics_def:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = all(passes(c) for c in checks)
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": int(run.cfg.get("chips", 1)) if on_card else 0,
              "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(run.records) + run.failed,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.dev_trace is not None:
        device["busy_s"] = run.dev_trace.busy_s()
        device["window_s"] = run.dev_trace.window_s
        out["breakdown"] = {"device_ops": run.dev_trace.top_ops(10),
                            "idle_gaps": run.dev_trace.idle_gaps(10)}
    out["checks"] = check_lines(checks)
    return out


def passes(check) -> bool:
    """A check ``(name, value, limit)`` holds ``value <= limit``; one with
    a fourth item ``">="`` holds ``value >= limit``.  NaN passes neither."""
    _n, v, lim, *op = check
    return bool(v >= lim) if op == [">="] else bool(v <= lim)


def check_lines(checks) -> dict:
    out = {}
    for name, v, lim, *op in checks:
        out[name] = {"value": float(v), "limit": float(lim)}
        if op:
            out[name]["at_least"] = True
    return out


def main(argv=None) -> int:
    import argparse

    t_begin = time.perf_counter()
    p = argparse.ArgumentParser(description="Run one benchmark cell and print its result line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        bench = load_json(ROOT / "BENCHMARK.json")
        w, _ = find_cell(bench, args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
            raise BenchError(f"the cell needs {w['chips']} CUDA device(s); found "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        run, kind = prepare(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                            "cuda")
        run.cfg["chips"] = w["chips"]
        result = execute(bench, run, kind, t_begin)
        bad = forbidden_modules()
        if bad:
            raise BenchError(f"loaded modules that must not load: {bad}")
    except BenchError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {name}: {c['value']!r} ({rel} limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
