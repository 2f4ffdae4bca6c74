"""BENCHMARK.json and the files it names: every cell, configuration, mix and
metric resolves by name, and the file keeps to the benchmark's contract."""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness as H  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|proj|head|expan|per_tok"
                   r"|channels|tile|shape)")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"][1].startswith("perfbench/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_entry_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_states_its_cut(entry):
    assert entry["file"].startswith("perfbench/configs/")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert key in cfg and not WIDTH.search(key)
        assert f"source_{key}" in cfg  # the published value beside the cut one
    assert cfg["precision"] == "float32" and "guarantee" in cfg and "assumed" in cfg


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    w, centry = H.find_cell(BENCH, cell)
    assert w["chips"] == 1
    mix = json.loads((ROOT / "perfbench" / "workloads" / f"{w['traffic']}.json").read_text())
    kind = ROOT / "perfbench" / "traffic" / f"{mix['kind']}.py"
    assert kind.is_file() and (ROOT / centry["file"]).is_file()


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_has_a_reader(metric):
    path = ROOT / "perfbench" / "readers" / f"{metric['name']}.py"
    assert hasattr(H._load(path, "reader_under_test"), "read")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moved_metric_is_reported_in_each_cell(metric):
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert H.applies(moved, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if H.applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(H.applies(m, cell) for m in BENCH["per_layer"])


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
