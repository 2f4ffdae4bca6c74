"""Port parity: retry, fault injection, the commit journal and resume of the
streaming executor (``repro_torch.runtime.fault``, ``repro_torch.exec``),
against ``repro.runtime.fault`` and ``repro.exec`` on the CPU.

Everything here is bit-exact: the streams are Lorenzo, whose containers
are integer paths.  A faulted, retried or resumed port stream ends in the
reference's clean bytes; the journal's bytes equal the reference's after
the same commits; each package resumes the partial container and journal
the other left, to the reference's clean bytes.
"""
import io
import os

import numpy as np
import pytest

from repro import exec as rexec
from repro.runtime import fault as rfault
from repro_torch import api, cli
from repro_torch.data import nyx_like_field
from repro_torch.errors import CorruptContainerError
from repro_torch.exec import GWTCWriter, journal_path, plan_stream, stream_compress
from repro_torch.runtime import fault as pfault
from repro_torch.runtime.fault import FailureInjector, RetryPolicy
from repro_torch.sz import tiled

CPU = "cpu"
PKGS = {"ref": rfault, "port": pfault}
# 24^3 in 8^3 tiles: 27 tiles, 4 a batch under the budget -> 7 batches
KW = dict(abs_eb=1e-3, tile=(8, 8, 8), mem_budget=50_000, predictor="lorenzo")


@pytest.fixture(scope="module")
def field():
    x = nyx_like_field((24, 24, 24), "temperature", seed=21)
    return x / np.float32(np.abs(x).max())


def _stream(field, out, **kw):
    return stream_compress(field, str(out), **KW, device=CPU, **kw)


def _ref_stream(field, out, **kw):
    return rexec.stream_compress(field, str(out), **KW, **kw)


@pytest.fixture(scope="module")
def clean_bytes(field, tmp_path_factory):
    """The reference's uninterrupted stream: every port run below must end
    in these bytes."""
    out = tmp_path_factory.mktemp("clean") / "ref.gwtc"
    rep = _ref_stream(field, out)
    assert rep.n_batches == 7 and rep.retries == 0
    return out.read_bytes()


# ---------------------------------------------------------------------------
# RetryPolicy / FailureInjector, on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", list(PKGS))
def test_retry_policy_survives_transients_then_succeeds(pkg):
    calls, waited, seen = [], [], []
    pol = PKGS[pkg].RetryPolicy(max_attempts=3, backoff=0.01)

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("blip")
        return "ok"

    out = pol.run(flaky, on_retry=lambda e, a: seen.append((str(e), a)), sleep=waited.append)
    assert out == "ok" and len(calls) == 3
    assert [a for _, a in seen] == [0, 1]
    assert waited == [pytest.approx(0.01), pytest.approx(0.02)], \
        "backoff must be exponential in the attempt index"


@pytest.mark.parametrize("pkg", list(PKGS))
def test_retry_policy_exhausts_and_raises_last_error(pkg):
    n = []

    def always():
        n.append(1)
        raise OSError("disk went away")

    with pytest.raises(OSError, match="disk went away"):
        PKGS[pkg].RetryPolicy(max_attempts=2, backoff=0.0).run(always, sleep=lambda _: None)
    assert len(n) == 2, "max_attempts bounds the total tries, not the retries"


@pytest.mark.parametrize("pkg", list(PKGS))
def test_retry_policy_only_retries_declared_exceptions(pkg):
    n = []

    def bad():
        n.append(1)
        raise ValueError("programming error")

    with pytest.raises(ValueError):
        PKGS[pkg].RetryPolicy(max_attempts=5).run(bad, sleep=lambda _: None)
    assert len(n) == 1, "a non-transient error must propagate on attempt 1"
    with pytest.raises(ValueError, match="max_attempts"):
        PKGS[pkg].RetryPolicy(max_attempts=0)


def test_retry_policy_delays_match_the_reference():
    for kw in (dict(backoff=0.05), dict(backoff=0.1, max_attempts=5), dict(backoff=0.0)):
        rpol, ppol = rfault.RetryPolicy(**kw), pfault.RetryPolicy(**kw)
        fields = ("max_attempts", "backoff", "retry_on")
        assert [getattr(ppol, f) for f in fields] == [getattr(rpol, f) for f in fields]
        for attempt in range(4):
            assert ppol.delay(attempt) == rpol.delay(attempt) == kw["backoff"] * 2.0**attempt


@pytest.mark.parametrize("pkg", list(PKGS))
def test_failure_injector_fires_each_step_n_times(pkg):
    inj = PKGS[pkg].FailureInjector({2, 5}, exc=OSError, attempts=2)
    for step in range(7):
        expect = step in (2, 5)
        for attempt in range(3):
            if expect and attempt < 2:
                with pytest.raises(OSError, match=f"step {step}"):
                    inj.maybe_fail(step)
            else:
                inj.maybe_fail(step)
    assert inj.failed == {2: 2, 5: 2}
    factory = PKGS[pkg].FailureInjector({1}, exc=lambda s: KeyError(f"lane {s}"))
    with pytest.raises(KeyError, match="lane 1"):
        factory.maybe_fail(1)
    factory.maybe_fail(1)  # fired once: passes now


# ---------------------------------------------------------------------------
# executor: retry over injected device / host faults
# ---------------------------------------------------------------------------


def test_stream_survives_transient_device_fault(tmp_path, field, clean_bytes):
    """A RuntimeError in the device encode of one batch is retried and the
    container is byte-identical to the reference's clean run."""
    out = tmp_path / "x.gwtc"
    rep = _stream(field, out, injector=FailureInjector({1}),
                  retry=RetryPolicy(max_attempts=3, backoff=0.0))
    assert rep.retries == 1 and rep.failed_batches == (1,)
    assert out.read_bytes() == clean_bytes
    assert not os.path.exists(journal_path(out)), "finalize must remove the commit journal"


def test_stream_survives_transient_append_fault(tmp_path, field, clean_bytes):
    """A transient OSError while appending a mid-batch lane is survived by
    rollback to the last commit + retry, with no duplicated or torn lanes."""
    out = tmp_path / "x.gwtc"
    rep = _stream(field, out, write_injector=FailureInjector({9}, exc=OSError),
                  retry=RetryPolicy(max_attempts=3, backoff=0.0))
    assert rep.retries == 1 and rep.failed_batches == (2,), \
        "lane 9 lives in batch 2 (4 tiles per batch)"
    assert out.read_bytes() == clean_bytes
    with api.open(out, verify="full", device=CPU) as vol:
        np.testing.assert_allclose(np.asarray(vol), field, atol=1e-3 * 1.01)


def test_stream_hard_fault_leaves_resumable_partial(tmp_path, field, clean_bytes):
    """Exhausted retries leave the partial container AND its journal on
    disk, and ``resume=True`` finishes the stream byte-identically."""
    out = tmp_path / "x.gwtc"
    with pytest.raises(RuntimeError, match="injected failure"):
        _stream(field, out, injector=FailureInjector({3}, attempts=5),
                retry=RetryPolicy(max_attempts=2, backoff=0.0))
    assert os.path.exists(out) and os.path.exists(journal_path(out)), \
        "a journaled stream must keep its partial output for resume"
    rep = _stream(field, out, resume=True)
    assert rep.resumed_batches == 3, "batches 0-2 were committed before the fault"
    assert rep.n_batches == 7
    assert out.read_bytes() == clean_bytes
    assert not os.path.exists(journal_path(out))
    with api.open(out, verify="full", device=CPU) as vol:
        np.testing.assert_allclose(np.asarray(vol), field, atol=1e-3 * 1.01)


def test_stream_to_a_file_object_unjournaled(field, clean_bytes):
    """A file-object destination writes no journal; a hard fault there is
    not resumable, and a clean run still gives the reference's bytes."""
    buf = io.BytesIO()
    rep = stream_compress(field, buf, **KW, device=CPU)
    assert rep.path is None and buf.getvalue() == clean_bytes
    with pytest.raises(RuntimeError):
        stream_compress(field, io.BytesIO(), **KW, device=CPU,
                        injector=FailureInjector({1}, attempts=9),
                        retry=RetryPolicy(max_attempts=2, backoff=0.0))


def test_file_object_stream_rolls_back_a_transient_append_fault(field, clean_bytes):
    """A file-object destination is truncated back to its commit point too:
    a transient OSError mid-batch is retried without torn or doubled lanes."""
    buf = io.BytesIO()
    rep = stream_compress(field, buf, **KW, device=CPU,
                          write_injector=FailureInjector({13}, exc=OSError),
                          retry=RetryPolicy(max_attempts=3, backoff=0.0))
    assert rep.retries == 1 and rep.failed_batches == (3,)
    assert buf.getvalue() == clean_bytes


def test_resume_noop_when_nothing_committed(tmp_path, field, clean_bytes):
    """A fault in batch 0 commits nothing; resume rebuilds the container
    from lane 0."""
    out = tmp_path / "x.gwtc"
    with pytest.raises(RuntimeError):
        _stream(field, out, injector=FailureInjector({0}, attempts=9),
                retry=RetryPolicy(max_attempts=2, backoff=0.0))
    rep = _stream(field, out, resume=True)
    assert rep.resumed_batches == 0
    assert out.read_bytes() == clean_bytes


def test_resume_mid_batch_commit_redoes_the_batch(tmp_path, field, clean_bytes):
    """A journal whose commit point falls mid-batch (6 of 27 lanes, batches
    of 4) is truncated to the batch boundary and re-streamed."""
    out = tmp_path / "x.gwtc"
    lanes = tiled.TiledCompressed.from_bytes(clean_bytes).tile_blobs
    w = GWTCWriter(out, shape=field.shape, tile=(8, 8, 8), eb_abs=1e-3, predictor="lorenzo")
    for lane in lanes[:6]:
        w.append_lane(lane)
    w.commit()
    w.abort()
    rep = _stream(field, out, resume=True)
    assert rep.resumed_batches == 1
    assert out.read_bytes() == clean_bytes


def test_resume_validation_errors(tmp_path, field):
    from repro_torch.core.trainer import GWLZTrainConfig

    out = tmp_path / "x.gwtc"
    with pytest.raises(FileNotFoundError, match="journal"):
        _stream(field, out, resume=True)  # nothing to resume
    with pytest.raises(ValueError, match="path"):
        stream_compress(field, io.BytesIO(), **KW, device=CPU, resume=True)
    with pytest.raises(ValueError, match="enhance"):
        _stream(field, out, resume=True, enhance=GWLZTrainConfig(n_groups=2, epochs=1))
    # a partial written with other settings: the header disagrees with the encode
    with pytest.raises(RuntimeError):
        _stream(field, out, injector=FailureInjector({3}, attempts=9),
                retry=RetryPolicy(max_attempts=2, backoff=0.0))
    with pytest.raises(ValueError, match="does not match the encode settings"):
        stream_compress(field, str(out), **{**KW, "abs_eb": 2e-3}, device=CPU, resume=True)


def test_resume_rejects_tampered_prefix(tmp_path, field):
    out = tmp_path / "x.gwtc"
    with pytest.raises(RuntimeError):
        _stream(field, out, injector=FailureInjector({3}, attempts=9),
                retry=RetryPolicy(max_attempts=2, backoff=0.0))
    blob = bytearray(out.read_bytes())
    blob[tiled._HDR_V3.size + 2] ^= 0xFF  # corrupt a shape dim on disk
    out.write_bytes(bytes(blob))
    with pytest.raises(CorruptContainerError, match="prefix"):
        GWTCWriter.resume(out)


def test_plan_resume_point_rounds_down():
    plan = plan_stream((24, 24, 24), (8, 8, 8), mem_budget=50_000, predictor="lorenzo")
    rplan = rexec.plan_stream((24, 24, 24), (8, 8, 8), mem_budget=50_000,
                              predictor="lorenzo", devices=1)
    assert plan.batch_tiles == rplan.batch_tiles == 4 and plan.n_tiles == 27
    for committed, want in ((0, 0), (4, 4), (9, 8), (999, 24)):
        assert plan.resume_point(committed) == rplan.resume_point(committed) == want
    ids = [i for run in plan.batches(8) for i in run]
    assert ids == list(range(8, 27))
    with pytest.raises(ValueError, match="aligned"):
        list(plan.batches(3))  # generator: the guard fires on iteration


def test_writer_commit_journal_roundtrip(tmp_path):
    """Abort keeps the (partial, journal) pair; resume truncates uncommitted
    bytes and replays the commit state."""
    path = tmp_path / "w.gwtc"
    w = GWTCWriter(path, shape=(16, 16, 16), tile=(8, 8, 8), eb_abs=1e-3)
    for blob in (b"aaaa", b"bb"):
        w.append_lane(blob)
    w.commit()
    w.append_lane(b"cccccc")  # never committed
    assert w.lanes_written == 3 and w.committed_lanes == 2
    w.abort()
    assert os.path.exists(journal_path(path))

    w2 = GWTCWriter.resume(path)
    assert w2.committed_lanes == 2
    w2.append_lane(b"zz")
    assert w2.rollback_uncommitted() == 1 and w2.lanes_written == 2
    for blob in (b"cccccc", *[b"dd"] * 5):
        w2.append_lane(blob)
    w2.commit()
    w2.finalize()
    assert not os.path.exists(journal_path(path))
    art = tiled.TiledCompressed.from_bytes(path.read_bytes())
    assert [bytes(b) for b in art.tile_blobs] == [b"aaaa", b"bb", b"cccccc"] + [b"dd"] * 5
    assert art.lane_crcs is not None and len(art.lane_crcs) == 8
    with pytest.raises(ValueError, match="finalized"):
        w2.append_lane(b"x")


def test_writer_context_manager_finalizes_or_aborts(tmp_path):
    path = tmp_path / "c.gwtc"
    with GWTCWriter(path, shape=(8, 8), tile=(4, 4), eb_abs=0.5) as w:
        for _ in range(4):
            w.append_lane(b"l")
    assert tiled.TiledCompressed.from_bytes(path.read_bytes()).n_tiles == 4
    bad = tmp_path / "a.gwtc"
    with pytest.raises(KeyError):
        with GWTCWriter(bad, shape=(8, 8), tile=(4, 4), eb_abs=0.5) as w:
            w.append_lane(b"l")
            w.commit()
            raise KeyError("boom")
    assert os.path.exists(journal_path(bad)), "an aborted path writer stays resumable"
    with pytest.raises(ValueError, match="needs 4 lanes"):
        GWTCWriter(io.BytesIO(), shape=(8, 8), tile=(4, 4), eb_abs=0.5).finalize()


def test_writer_torn_journal_block_falls_back_to_previous_commit(tmp_path):
    path = tmp_path / "w.gwtc"
    w = GWTCWriter(path, shape=(16, 16, 16), tile=(8, 8, 8), eb_abs=1e-3)
    w.append_lane(b"aaaa")
    w.commit()
    w.append_lane(b"bbbb")
    w.commit()
    w.abort()
    jp = journal_path(path)
    with open(jp, "r+b") as f:  # tear the tail of the last commit block
        f.truncate(os.path.getsize(jp) - 3)
    w2 = GWTCWriter.resume(path)
    assert w2.committed_lanes == 1, "a torn block must yield to the prior commit"
    w2.abort()
    with open(jp, "r+b") as f:  # a journal without its prefix CRC is unusable
        f.truncate(8)
    with pytest.raises(CorruptContainerError, match="journal"):
        GWTCWriter.resume(path)


# ---------------------------------------------------------------------------
# the journal across packages
# ---------------------------------------------------------------------------


def _commits(W, path):
    """The same append/commit/truncate sequence on either package's writer;
    returns the journal's bytes after each step."""
    w = W(path, shape=(16, 16, 16), tile=(8, 8, 8), eb_abs=1e-3, predictor="lorenzo")
    seen = [open(journal_path(path), "rb").read()]
    for lanes in ((b"aaaa", b"bb"), (b"c" * 7,), (b"dd", b"e", b"ffff")):
        for lane in lanes:
            w.append_lane(lane)
        w.commit()
        seen.append(open(journal_path(path), "rb").read())
    w.truncate_lanes(2)
    seen.append(open(journal_path(path), "rb").read())
    w.abort()
    seen.append(path.read_bytes())
    return seen


def test_journal_bytes_equal_the_reference(tmp_path):
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    assert _commits(GWTCWriter, tmp_path / "p" / "w.gwtc") == \
        _commits(rexec.GWTCWriter, tmp_path / "r" / "w.gwtc")


@pytest.mark.parametrize("direction", ["port_resumes_reference", "reference_resumes_port"])
def test_cross_package_resume_gives_the_reference_bytes(tmp_path, field, clean_bytes,
                                                        direction):
    """A hard fault in one package leaves (partial, journal); the other
    resumes it to the reference's clean bytes.  Both partials are equal."""
    outs = {}
    for pkg, run, F, R in (("ref", _ref_stream, rfault.FailureInjector, rfault.RetryPolicy),
                           ("port", _stream, FailureInjector, RetryPolicy)):
        out = tmp_path / f"{pkg}.gwtc"
        fail = dict(injector=F({4}, attempts=9), retry=R(max_attempts=2, backoff=0.0))
        with pytest.raises(RuntimeError):
            run(field, out, **fail)
        outs[pkg] = out
    assert outs["ref"].read_bytes() == outs["port"].read_bytes()
    assert open(journal_path(outs["ref"]), "rb").read() == \
        open(journal_path(outs["port"]), "rb").read()
    if direction == "port_resumes_reference":
        out = outs["ref"]
        rep = _stream(field, out, resume=True)
    else:
        out = outs["port"]
        rep = _ref_stream(field, out, resume=True)
    assert rep.resumed_batches == 4
    assert out.read_bytes() == clean_bytes
    assert not os.path.exists(journal_path(out))


# ---------------------------------------------------------------------------
# the CI smokes (.github/workflows/ci.yml), replayed on the port
# ---------------------------------------------------------------------------


def test_ci_streaming_and_fault_smoke_replayed(tmp_path, capsys):
    """The streaming smoke (CLI --stream on a .npy under a 128K budget, info,
    region) and the fault-injection smoke (transient faults survived, a
    hard fault, a byte-identical resume, verify), on the port's front doors
    at the CI's sizes; every container equals the reference's."""
    src = tmp_path / "stream_src.npy"
    x = nyx_like_field((48, 48, 48), "temperature", seed=3)
    np.save(src, x)
    stream = tmp_path / "stream.gwtc"
    dev = ["--device", CPU]
    assert cli.main(dev + ["compress", str(src), str(stream), "--eb", "1e-3", "--stream",
                           "--mem-budget", "128K", "--tile", "16",
                           "--predictor", "lorenzo"]) == 0
    assert "in 27 batches of 1 tiles" in capsys.readouterr().out
    assert cli.main(dev + ["info", str(stream)]) == 0
    roi = tmp_path / "stream_roi.npy"
    assert cli.main(dev + ["region", str(stream), "--roi", "8:24,0:16,32:48",
                           "--out", str(roi)]) == 0
    with api.open(stream, device=CPU) as vol:
        full = np.asarray(vol)
        assert np.array_equal(np.load(roi), full[8:24, 0:16, 32:48])
        assert np.max(np.abs(full - x)) <= vol.eb_abs * (1 + 1e-6)

    kw = dict(rel_eb=1e-3, tile=(16, 16, 16), mem_budget=128 << 10, predictor="lorenzo")
    rexec.stream_compress(x, str(tmp_path / "ref.gwtc"), **kw)
    ref = (tmp_path / "ref.gwtc").read_bytes()
    assert stream.read_bytes() == ref
    flaky = tmp_path / "flaky.gwtc"
    rep = stream_compress(x, str(flaky), **kw, device=CPU, injector=FailureInjector({1}),
                          write_injector=FailureInjector({5}, exc=OSError),
                          retry=RetryPolicy(max_attempts=3, backoff=0.0))
    assert rep.retries == 2, rep.retries
    assert flaky.read_bytes() == ref
    killed = tmp_path / "killed.gwtc"
    with pytest.raises(RuntimeError):
        stream_compress(x, str(killed), **kw, device=CPU,
                        injector=FailureInjector({2}, attempts=9),
                        retry=RetryPolicy(max_attempts=2, backoff=0.0))
    assert os.path.exists(journal_path(killed))
    rep = stream_compress(x, str(killed), **kw, device=CPU, resume=True)
    assert rep.resumed_batches > 0
    assert killed.read_bytes() == ref
    api.open(killed, verify="full", device=CPU).close()
    assert cli.main(dev + ["verify", str(killed)]) == 0
