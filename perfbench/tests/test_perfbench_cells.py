"""Every cell's traffic at a small size on the CPU: the result line, the
check against the reference, its control and the faults it must catch,
and a cell added from new files alone."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from perfbench import control  # noqa: E402
from perfbench import harness as H  # noqa: E402

BENCH = H.load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
ENHANCE = {**H.load_json(ROOT / "perfbench/configs/nyx512-gwlz-lorenzo.json")["enhance"],
           "n_groups": 3}


def small(cell: str) -> dict:
    """The cell at 32^3 with 16^3 tiles.  GWLZ: 3 groups, 1 epoch, which
    gain ~0.2% of the squared error at this size (one group passes the
    gate), so the gain's limit here is 0.1%."""
    cfg = {"shape": [32, 32, 32], "tile": [16, 16, 16]}
    if BENCH_CFG[cell] == "nyx512-gwlz-lorenzo":
        limits = H.load_json(ROOT / "perfbench/configs/nyx512-gwlz-lorenzo.json")["limits"]
        cfg.update(enhance=ENHANCE, limits={**limits, "enh_gain_pct": 0.1})
    return {"cfg": cfg, "mix": {}}


BENCH_CFG = {w["name"]: w["config"] for w in BENCH["workloads"]}


def run_cell(cell: str, trace: bool = False, seconds: float = 0.05, seed: int = 2**31 + 7):
    run, kind = H.prepare(BENCH, cell, seed, seconds, trace, "cpu", small(cell))
    return H.execute(BENCH, run, kind, time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(cell):
    out = run_cell(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    want = {m["name"] for m in BENCH["end_to_end"] if H.applies(m, cell)}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("cell", ["sz-write", "gwlz-read"])
def test_result_line_schema_of_a_traced_run(cell):
    out = run_cell(cell, trace=True)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
                                  "window_s"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    per_layer = {m["name"] for m in BENCH["per_layer"] if H.applies(m, cell)}
    assert set(out["metrics"]) <= per_layer and out["metrics"]
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(cell):
    got = control.control_run(BENCH, cell, 17, 0.05, "cpu", small(cell))
    assert not got["correct"], got["checks"]


def _alter_first(t: torch.Tensor, by: float) -> torch.Tensor:
    t = t.clone()
    t.view(-1)[0] += by
    return t


FAULTS = {
    # an answer altered where it is produced: one code before entropy coding
    "code": ("repro_torch.sz.entropy", "encode_codes_lanes",
             lambda f: lambda codes, *a, **k: f(_alter_first(codes, 1), *a, **k)),
    # half of the batch left out: the second half of every lane decode zeroed
    "half": ("repro_torch.sz.tiled", "decode_lanes",
             lambda f: lambda *a, **k: _zero_half(f(*a, **k))),
    # a step that returns its state unchanged: no training step moves a weight
    "unchanged": ("repro_torch.core.trainer", "train_step",
                  lambda f: lambda enh, *a, n_groups, **k: torch.zeros(n_groups)),
    # half of each training batch left out; Adam without its bias correction
    **control.TRAIN_FAULTS,
}


def _zero_half(res):
    recon = res[0].clone()
    recon[recon.shape[0] // 2:] = 0
    return (recon,) + tuple(res[1:])


@pytest.mark.parametrize("cell,fault", [
    ("gwlz-write", "code"), ("gwlz-write", "unchanged"), ("gwlz-write", "half_batch"),
    ("gwlz-write", "no_bias_correction"), ("sz-write", "code"),
    ("gwlz-read", "half")])
def test_check_catches_a_broken_timed_path(cell, fault, monkeypatch):
    import importlib

    mod_name, fn, wrap = FAULTS[fault]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, fn, wrap(getattr(mod, fn)))
    out = run_cell(cell)
    assert not out["correct"], out["checks"]
    if fault in control.TRAIN_FAULTS:  # caught by the training numbers
        assert any(out["checks"][k]["value"] > out["checks"][k]["limit"]
                   for k in ("train_loss_gap", "train_grad_gap", "train_step_gap"))


def test_training_control_fails_the_training_numbers():
    """The reference's first steps in bfloat16, in the program's place, at
    a small size: the numbers of ``perfbench/control.py --train``."""
    got = next(control.training_readings(BENCH, "gwlz-write", [5], "cpu",
                                         overrides=small("gwlz-write")))
    lims = small("gwlz-write")["cfg"]["limits"]
    assert all(v <= lims[k] for k, v in got["sound"].items()), got
    assert any(v > lims[k] for k, v in got["control"].items()), got


def test_a_cell_added_from_new_files_alone(tmp_path):
    """A copy of the benchmark gains a mix, a reader and a cell in new files
    and new BENCHMARK.json entries; the harness finds them by name."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())  # as committed
    (tmp_path / "perfbench" / "workloads" / "write-2fields.json").write_text(json.dumps(
        {**json.loads((ROOT / "perfbench/workloads/write-4fields.json").read_text()),
         "fields": 2, "check_ops": 1, "why": "two fields"}))
    (tmp_path / "perfbench" / "readers" / "write_ops.py").write_text(
        "def read(run):\n    return len(run.records)\n")
    bench["workloads"].append({"name": "sz-write-2", "config": "nyx512-sz-interp",
                               "traffic": "write-2fields", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "write_ops", "unit": "ops", "better": "higher",
                               "source": "host_clock", "layer": "whole op",
                               "moves": "compress_GBps", "workloads": ["sz-write-2"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("compress_GBps", "ratio"):
            m["workloads"].append("sz-write-2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys, time; sys.path.insert(0, '.')\n"
            "from perfbench import harness as H\n"
            "b = H.load_json(H.ROOT / 'BENCHMARK.json')\n"
            "run, kind = H.prepare(b, 'sz-write-2', 5, 0.05, True, 'cpu', "
            "{'cfg': {'shape': [32, 32, 32], 'tile': [16, 16, 16]}})\n"
            "print(json.dumps(H.execute(b, run, kind, time.perf_counter())))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=240, env={**os.environ, "PYTHONPATH": ""})
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["metrics"]["write_ops"]["value"] >= 1


def test_run_without_a_card_prints_no_result():
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "sz-write",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and res.stdout.strip() == ""
