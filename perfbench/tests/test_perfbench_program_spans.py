"""The readers of the program's own spans (``program_spans.py``): each span
goes to the window op whose interval holds it, op 0 is left out, launches
are counted inside their spans, a program without the recorder gives no
number, and a traced run at a small size reads every new metric."""
from __future__ import annotations

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from perfbench import harness as H  # noqa: E402
from perfbench import program_spans as P  # noqa: E402
from perfbench.trace import DeviceTrace  # noqa: E402
from repro_torch import obs  # noqa: E402

BENCH = H.load_json(ROOT / "BENCHMARK.json")
NEW = {m["name"]: m for m in BENCH["per_layer"] if m["source"] == "program_span"
       and m["name"] not in ("gwlz_train_s", "entropy_host_s.write", "entropy_host_s.read")}


def _span(name, t0, t1, **attrs):
    return obs.Record(name, int(t0 * 1e9), int(t1 * 1e9), 0, 0, 0, 0, attrs)


def _run(recs, ops=((0.0, 1.0), (1.0, 2.0), (2.5, 4.0))):
    records = [{"i": i, "t0": a, "t1": b} for i, (a, b) in enumerate(ops)]
    run = SimpleNamespace(records=records, state={}, dev_trace=None)
    run.state["program_spans"] = P.assign(recs, records)
    return run


def test_spans_go_to_the_op_that_holds_them_and_op_0_is_left_out():
    recs = [_span("lane.inflate", 0.1, 0.3),  # op 0: profiled, left out
            _span("lane.inflate", 1.1, 1.2), _span("lane.inflate", 1.5, 1.9),
            _span("lane.inflate", 2.0, 2.2),  # between ops: no op's
            _span("lane.inflate", 1.9, 2.6),  # crosses an op's end: no op's
            _span("lane.inflate", 3.0, 3.5), _span("lane.decode", 3.5, 3.75)]
    run = _run(recs)
    assert [len(ops) for ops in P.per_op(run)] == [2, 2]
    assert P.seconds(run, "lane.inflate") == pytest.approx((0.5 + 0.5) / 2)
    assert P.seconds(run, "lane.decode") == pytest.approx((0.0 + 0.25) / 2)
    assert P.seconds(run, "lane.tables") is None


def test_share_of_spans_with_an_attribute():
    recs = [_span("lane.tables", 1.1, 1.2, hit=True), _span("lane.tables", 1.2, 1.3, hit=False),
            _span("lane.tables", 3.0, 3.1, hit=False), _span("lane.tables", 0.2, 0.3, hit=True)]
    assert P.share_pct(_run(recs), "lane.tables", "hit") == pytest.approx((50 + 0) / 2)
    assert P.share_pct(_run([]), "lane.tables", "hit") is None


def test_launches_counted_inside_their_spans():
    host = [("train.step", 10.0, 20.0), ("train.step", 30.0, 40.0),
            ("cudaLaunchKernel", 11.0, 12.0), ("cudaLaunchKernelExC", 13.0, 13.5),
            ("cuLaunchKernel", 14.0, 14.5), ("cudaMemcpyAsync", 31.0, 32.0),
            ("cudaMemsetAsync", 33.0, 33.5), ("cudaStreamSynchronize", 34.0, 35.0),
            ("cudaLaunchKernel", 25.0, 26.0),  # between steps
            ("aten::mm", 15.0, 16.0)]
    run = SimpleNamespace(dev_trace=DeviceTrace(host=host))
    assert P.launches_per_span(run, "train.step") == pytest.approx(5 / 2)
    assert P.launches_per_span(SimpleNamespace(dev_trace=DeviceTrace()), "train.step") is None
    assert P.launches_per_span(SimpleNamespace(dev_trace=None), "train.step") is None


def test_a_program_without_the_recorder_gives_no_number(monkeypatch):
    monkeypatch.setattr(P, "_obs", lambda: None)
    P.record()
    run = SimpleNamespace(records=[{"i": 0, "t0": 0.0, "t1": 1.0},
                                   {"i": 1, "t0": 1.0, "t1": 2.0}], state={})
    assert P.seconds(run, "entropy.fit") is None
    assert P.share_pct(run, "lane.tables", "hit") is None


@pytest.fixture
def one_thread():
    """One intra-op thread: the suite runs in parallel workers, where many
    threads a worker make the small ops here wait on each other."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cell", ["gwlz-write", "gwlz-read"])  # every new metric's cells
def test_traced_run_reads_every_new_metric_and_leaves_the_recorder_off(cell, one_thread):
    sys.path.insert(0, str(Path(__file__).parent))
    from test_perfbench_cells import small

    run, kind = H.prepare(BENCH, cell, 2**31 + 11, 0.05, True, "cpu", small(cell))
    out = H.execute(BENCH, run, kind, time.perf_counter())
    assert out["correct"], out["checks"]
    want = {n for n, m in NEW.items() if H.applies(m, cell)}
    assert want and want <= set(out["metrics"])
    assert not obs.enabled() and obs.take() == []
