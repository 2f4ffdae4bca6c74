"""The port's span recorder (``repro_torch.obs``): off it reads no clock and
opens no profiler range; on, spans nest, carry their request's id, land in
a profiler trace as host events around the torch ops they issue, and time
the GWLZ phases with the same clock reads as ``GWLZStats.seconds``."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import api, obs
from repro_torch.core.trainer import GWLZTrainConfig
from repro_torch.data import nyx_like_field

CFG = GWLZTrainConfig(n_groups=4, epochs=1)
TILE = (16, 16, 16)
PHASES = ("sz", "decode", "edges", "train", "calibrate", "gate", "enhance")
# every span a tiled compress, to_bytes, open and whole decode records (the
# names the benchmark's readers and PERF.md's layers use)
SPANS = {
    "op.compress", "op.to_bytes", "op.open", "op.decode", "op.to_host",
    *(f"gwlz.{p}" for p in PHASES), "gwlz.stats", "gwlz.enhance_tiles", "train.step",
    "tiles.encode", "tiles.lanes", "entropy.encode", "entropy.fit", "entropy.pack",
    "entropy.splice", "entropy.deflate",
    "lane.crc", "lane.parse", "lane.inflate", "lane.tables", "lane.decode",
    "tiles.decode", "tiles.stitch",
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in parallel workers, where many
    threads a worker make the small ops here wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def recorder():
    obs.enable()
    obs.take()
    yield
    obs.disable()
    obs.take()


@pytest.fixture(scope="module")
def field():
    return nyx_like_field((32, 32, 32), "temperature", seed=11)


def _round_trip(x, **kw):
    vol = api.compress(x, eb=1e-3, tiled=True, tile=TILE, device="cpu", **kw)
    out = np.asarray(api.from_bytes(vol.to_bytes(), device="cpu"))
    return vol, out


@pytest.fixture(scope="module")
def gwlz_trip(field):
    """One GWLZ round trip (Lorenzo) and one interp round trip with the
    recorder on: their records and the GWLZ handle."""
    obs.enable()
    obs.take()
    try:
        vol, _ = _round_trip(field, predictor="lorenzo", enhance=CFG)
        _round_trip(field, predictor="interp")
        return vol, obs.take()
    finally:
        obs.disable()


def _raise(*_a, **_k):
    raise AssertionError("reached with the recorder off")


def test_off_path_reads_no_clock_and_opens_no_range(monkeypatch, field):
    obs.disable()
    obs.take()
    monkeypatch.setattr(time, "perf_counter_ns", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    for kw in ({"predictor": "lorenzo", "enhance": CFG}, {"predictor": "interp"}):
        vol, out = _round_trip(field, **kw)
        assert np.abs(out - field).max() <= 2 * vol.eb_abs
    assert obs.take() == []


def test_spans_nest_and_carry_their_request(recorder):
    with obs.op("outer") as root:
        with obs.span("a", k=1) as a:
            with obs.span("b"):
                pass
            a.set(hit=True)
        with obs.op("inner"):  # nested: the same request
            with obs.span("c"):
                pass
    with obs.span("loose"):
        pass
    recs = {r.name: r for r in obs.take()}
    assert set(recs) == {"op.outer", "a", "b", "op.inner", "c", "loose"}
    assert root.id == recs["op.outer"].id and recs["op.outer"].parent == 0
    assert recs["a"].parent == recs["op.outer"].id and recs["b"].parent == recs["a"].id
    assert recs["c"].parent == recs["op.inner"].id
    assert recs["a"].attrs == {"k": 1, "hit": True}
    o, a, b = recs["op.outer"], recs["a"], recs["b"]
    assert o.t0_ns <= a.t0_ns <= b.t0_ns <= b.t1_ns <= a.t1_ns <= o.t1_ns
    ids = {recs[n].op for n in ("op.outer", "a", "b", "op.inner", "c")}
    assert len(ids) == 1 and ids != {0}
    assert recs["loose"].op == 0 and recs["loose"].parent == 0


def test_two_threads_get_two_requests(recorder):
    both = threading.Barrier(2, timeout=30)  # alive together: distinct thread ids

    def work():
        with obs.op("t"):
            with obs.span("s"):
                both.wait()

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    recs = obs.take()
    assert sorted(r.name for r in recs) == ["op.t", "op.t", "s", "s"]
    assert len({r.op for r in recs}) == 2 and len({r.thread for r in recs}) == 2
    for r in recs:
        if r.name == "s":
            assert any(p.id == r.parent and p.op == r.op for p in recs)
    assert obs.take() == []


def test_spans_are_profiler_host_events_around_their_ops(recorder, field):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _round_trip(field, predictor="interp")
    # the event's kind from the methods both the card's torch (2.11, no
    # ``activity_type``) and the CPU's have: the device it ran on, and
    # whether it is a user annotation
    events = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(),
               (e.device_type(), e.is_user_annotation()))
              for e in prof.profiler.kineto_results.events()]
    names = {e[0] for e in events}
    assert {"op.compress", "entropy.encode", "entropy.fit", "lane.parse", "lane.decode"} <= names
    # a host cpu_op range, not a user annotation: the profiler would mirror
    # an annotation onto the device timeline as if it were device work
    assert {e[4] for e in events if e[0] == "entropy.fit"} == {
        (torch.autograd.DeviceType.CPU, False)}
    for span, op in (("entropy.fit", "aten::aminmax"), ("lane.decode", "aten::index")):
        outer = [e for e in events if e[0] == span]
        inner = [e for e in events if e[0] == op]
        assert any(s[1] <= i[1] and i[2] <= s[2] and s[3] == i[3]
                   for s in outer for i in inner), (span, op)


def test_phase_seconds_are_the_phase_spans(gwlz_trip):
    vol, recs = gwlz_trip
    seconds = vol.train_stats.seconds
    spans = {r.name[5:]: r.seconds for r in recs if r.name.startswith("gwlz.")}
    assert tuple(seconds) == PHASES
    assert {k: spans[k] for k in PHASES} == seconds


def test_round_trip_emits_every_span(gwlz_trip):
    _vol, recs = gwlz_trip
    assert {r.name for r in recs} >= SPANS, SPANS - {r.name for r in recs}
    enc = [r for r in recs if r.name == "entropy.encode"]
    assert enc and all(r.attrs == {"lanes": 8, "batched": 8} for r in enc)
    assert {type(r.attrs.get("hit")) for r in recs if r.name == "lane.tables"} == {bool}
    assert [r.attrs["steps"] for r in recs if r.name == "gwlz.train"] == [
        sum(r.name == "train.step" for r in recs)]


def test_eager_training_steps_carry_no_graph_attribute(gwlz_trip):
    _vol, recs = gwlz_trip
    steps = [r for r in recs if r.name == "train.step"]
    assert steps and all("graph" not in r.attrs for r in steps)


def test_training_steps_on_the_card_are_graph_replays(recorder):
    """On a card every step of train_enhancers' loop replays its captured
    step, and its span says so."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    from repro_torch.core.trainer import train_enhancers

    x = torch.rand(24, 32, 32, device="cuda")
    train_enhancers(x, 0.01 * torch.randn_like(x), CFG, device="cuda")
    steps = [r for r in obs.take() if r.name == "train.step"]
    assert len(steps) == 24 // CFG.batch_size and all(r.attrs == {"graph": 1} for r in steps)


# every span of a streamed batch; ``stream.prepass`` is once a call
STREAM_SPANS = ("stream.read", "stream.h2d", "stream.encode", "stream.pack",
                "stream.reservoir", "stream.wait", "stream.append")
# two 16^3 tiles a batch on the CPU (12 bytes a value of working set, two
# batches in flight): the 32^3 field in four batches
STREAM_BUDGET = 2 * 2 * 12 * 16 ** 3


def _stream(x, path):
    return api.compress_stream(x, path, eb=1e-3, tile=TILE, mem_budget=STREAM_BUDGET,
                               enhance=CFG, device="cpu")


@pytest.fixture(scope="module")
def streamed(field, tmp_path_factory):
    """A GWLZ stream of the field in four batches with the recorder on:
    its report, its file and its records."""
    path = tmp_path_factory.mktemp("stream") / "s.gwtc"
    obs.enable()
    obs.take()
    try:
        rep = _stream(field, path)
        return rep, path, obs.take()
    finally:
        obs.disable()


def test_stream_spans_fire_once_a_batch(streamed):
    rep, _path, recs = streamed
    assert rep.n_batches == 4 and rep.batch_tiles == 2 and rep.enhanced
    names = [r.name for r in recs]
    assert names.count("op.stream") == 1 and names.count("stream.prepass") == 1
    for name in STREAM_SPANS:
        assert names.count(name) == rep.n_batches, name
    reads = [r for r in recs if r.name == "stream.read"]
    assert [r.attrs for r in reads] == [{"batch": b, "tiles": 2} for b in range(4)]
    for name in ("stream.pack", "stream.append"):  # on the worker, on the CPU
        got = [r for r in recs if r.name == name]
        assert all(r.attrs == {"lanes": 2} for r in got)
        assert {r.thread for r in got} != {reads[0].thread}
    # the caller's spans sit inside the request's root
    root = next(r for r in recs if r.name == "op.stream")
    assert all(r.op == root.op and root.t0_ns <= r.t0_ns and r.t1_ns <= root.t1_ns
               for r in recs if r.name in ("stream.read", "stream.wait"))


def test_region_spans_carry_the_caches_counts(streamed, recorder):
    _rep, path, _recs = streamed
    boxes = [(slice(0, 8), slice(4, 20), slice(0, 32)), (slice(0, 8), slice(4, 20), slice(0, 9)),
             (slice(10, 30), slice(0, 32), slice(15, 17))]
    with api.open(path, device="cpu") as vol:
        cache = vol.tile_cache
        for box in boxes:
            hits, misses = cache.hits, cache.misses
            vol[box]
            got = [r for r in obs.take() if r.name == "op.region"]
            assert len(got) == 1
            assert got[0].attrs == {"tiles": cache.hits - hits + cache.misses - misses,
                                    "hits": cache.hits - hits}
    assert got[0].attrs == {"tiles": 8, "hits": 4}  # the first box cached four of them


def test_stream_and_region_record_nothing_with_the_recorder_off(field, tmp_path):
    obs.disable()
    obs.take()
    _stream(field, tmp_path / "off.gwtc")
    with api.open(tmp_path / "off.gwtc", device="cpu") as vol:
        vol[0:8, 0:8, 0:8]
    assert obs.take() == []
