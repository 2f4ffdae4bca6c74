"""The reader of ``train_graph_share``: the share of ``train.step`` spans
that carry the program's ``graph`` attribute (a replay of the captured
training step), 0 where the spans lack it (an eager step, or a program
without the captured step) and no number where there are no such spans."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from perfbench import harness as H  # noqa: E402
from perfbench import program_spans as P  # noqa: E402
from repro_torch import obs  # noqa: E402


def _steps(t0: float, n: int, **attrs) -> list:
    return [obs.Record("train.step", int((t0 + k / 10) * 1e9), int((t0 + k / 10 + 0.05) * 1e9),
                       0, 0, 0, 0, dict(attrs)) for k in range(n)]


def _run(recs):
    records = [{"i": i, "t0": a, "t1": b} for i, (a, b) in enumerate(((0.0, 1.0), (1.0, 2.0),
                                                                       (2.5, 4.0)))]
    run = SimpleNamespace(records=records, state={}, dev_trace=None)
    run.state["program_spans"] = P.assign(recs, records)
    return run


@pytest.fixture
def reader():
    mod = H._load(ROOT / "perfbench" / "readers" / "train_graph_share.py",
                  "reader_train_graph_share")
    yield mod
    obs.disable()  # the reader turns the recorder on as it loads
    obs.take()


def test_eager_steps_read_0_and_replays_read_100(reader):
    assert reader.read(_run(_steps(1.1, 3))) == 0.0
    assert reader.read(_run(_steps(2.6, 3, graph=1))) == 100.0
    assert reader.read(_run(_steps(1.1, 3) + _steps(2.6, 3, graph=1))) == pytest.approx(50.0)
    assert reader.read(_run(_steps(0.1, 3, graph=1))) is None  # op 0 is left out
    assert reader.read(_run([])) is None
