"""The reader of ``deflate_pool_share``: the share of ``entropy.deflate``
spans that carry the program's ``pooled`` attribute (the lanes' zlib on
its pool of host threads), 0 where the spans lack it (one span a lane, or
a call kept on the caller) and no number where there are no such spans."""
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


def _deflates(t0: float, n: int, **attrs) -> list:
    return [obs.Record("entropy.deflate", int((t0 + k / 10) * 1e9),
                       int((t0 + k / 10 + 0.05) * 1e9), 0, 0, 0, 0, dict(attrs))
            for k in range(n)]


def _run(recs):
    records = [{"i": i, "t0": a, "t1": b} for i, (a, b) in enumerate(((0.0, 1.0), (1.0, 2.0),
                                                                       (2.5, 4.0)))]
    run = SimpleNamespace(records=records, state={}, dev_trace=None)
    run.state["program_spans"] = P.assign(recs, records)
    return run


@pytest.fixture
def reader():
    mod = H._load(ROOT / "perfbench" / "readers" / "deflate_pool_share.py",
                  "reader_deflate_pool_share")
    yield mod
    obs.disable()  # the reader turns the recorder on as it loads
    obs.take()


def test_serial_spans_read_0_and_pooled_spans_read_100(reader):
    assert reader.read(_run(_deflates(1.1, 3))) == 0.0  # a parent: one span a lane
    assert reader.read(_run(_deflates(1.1, 2, lanes=512, workers=1, pooled=False))) == 0.0
    assert reader.read(_run(_deflates(2.6, 1, lanes=512, workers=8, pooled=True))) == 100.0
    assert reader.read(_run(_deflates(1.1, 3) + _deflates(2.6, 1, pooled=True))) == \
        pytest.approx(50.0)
    assert reader.read(_run(_deflates(0.1, 3, pooled=True))) is None  # op 0 is left out
    assert reader.read(_run([])) is None
