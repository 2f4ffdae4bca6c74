"""Port parity: multi-field ``GWDS`` datasets (``repro_torch.api.Dataset``,
``repro_torch.exec.writer.GWDSWriter``, the CLI's ``--field``) against
``repro.api`` and ``repro.exec`` on the CPU.

Lorenzo envelopes are integer paths, so their bytes and decodes are held
bit for bit; the golden v1 envelope's interp field is held within 8
float32 ulps of max|x| of the reference's live decode (ROADMAP.md Queue 3,
"Interp goldens").
"""
import io
from pathlib import Path

import numpy as np
import pytest

from repro import api as rapi
from repro import cli as rcli
from repro import exec as rexec
from repro.runtime import fault as rfault
from repro_torch import api, cli
from repro_torch.data import nyx_like_field
from repro_torch.errors import CorruptContainerError
from repro_torch.exec import GWDSWriter, stream_compress
from repro_torch.exec.writer import parse_gwds
from repro_torch.runtime.fault import FailureInjector, RetryPolicy

CPU = "cpu"
GOLDEN = Path(__file__).resolve().parent / "golden"
SHAPE = (16, 24, 20)
TILE = (8, 8, 8)
EB = 1e-2
# the streamed field: 8 x 16 x 8 in 8^3 tiles, 2 lanes
STREAM_SHAPE, STREAM_KW = (8, 16, 8), dict(abs_eb=EB, tile=TILE, mem_budget=1 << 20)
PKGS = {"ref": (rexec.GWDSWriter, rexec.stream_compress, {}),
        "port": (GWDSWriter, stream_compress, {"device": CPU})}


@pytest.fixture(scope="module")
def field():
    x = nyx_like_field(SHAPE, "temperature", seed=4)
    return x / np.float32(np.abs(x).max())


@pytest.fixture(scope="module")
def vols(field):
    """name -> (port handle, reference handle over the same bytes): one
    monolithic and one tiled Lorenzo field."""
    mono = api.compress(field, abs_eb=EB, predictor="lorenzo", device=CPU)
    til = api.compress(field, abs_eb=2 * EB, predictor="lorenzo", tiled=True, tile=TILE,
                       device=CPU)
    return {n: (v, rapi.from_bytes(v.to_bytes())) for n, v in (("t", mono), ("rho", til))}


def _write_streamed(pkg: str, path, vols, field):
    """An envelope with one whole field and one streamed through the shared
    sink, written by ``pkg``."""
    writer, stream, kw = PKGS[pkg]
    x = np.ascontiguousarray(field[: STREAM_SHAPE[0], : STREAM_SHAPE[1], : STREAM_SHAPE[2]])
    w = writer(path)
    w.add_field("t", vols["t"][0].to_bytes())
    gw = w.stream_field("rho", shape=x.shape, tile=TILE, eb_abs=EB)
    stream(x, gw, **STREAM_KW, **kw)
    return w.finalize(), x


# ---------------------------------------------------------------------------
# bytes: Dataset.build, GWDSWriter eager and streamed, both packages
# ---------------------------------------------------------------------------


def test_build_bytes_equal_the_reference(vols, tmp_path):
    port = api.Dataset.build({n: v for n, (v, _r) in vols.items()})
    ref = rapi.Dataset.build({n: r for n, (_v, r) in vols.items()})
    assert port == ref and port[4] == 2
    written = api.save(tmp_path / "p.gwds", {n: v for n, (v, _r) in vols.items()})
    assert written == len(port) and (tmp_path / "p.gwds").read_bytes() == port
    # artifacts (not handles) and the eager writer give the same envelope
    buf = io.BytesIO()
    w = GWDSWriter(buf)
    for name, (v, _r) in vols.items():
        w.add_field(name, v.artifact)
    assert w.finalize() == len(port) and buf.getvalue() == port
    assert api.Dataset.build({n: v.artifact for n, (v, _r) in vols.items()}) == port


def test_streamed_field_bytes_equal_the_reference(vols, field, tmp_path):
    total, x = _write_streamed("port", tmp_path / "p.gwds", vols, field)
    _write_streamed("ref", tmp_path / "r.gwds", vols, field)
    blob = (tmp_path / "p.gwds").read_bytes()
    assert blob == (tmp_path / "r.gwds").read_bytes() and total == len(blob)
    eager = api.compress(x, abs_eb=EB, tiled=True, tile=TILE, predictor="lorenzo", device=CPU)
    # a streamed field equals the eager container, and the envelope equals
    # Dataset.build of the same two artifacts
    assert api.Dataset.build({"t": vols["t"][0], "rho": eager}) == blob
    with api.open(tmp_path / "p.gwds", device=CPU) as ds:
        assert ds["rho"].to_bytes() == eager.to_bytes()
        np.testing.assert_array_equal(np.asarray(ds["rho"]), np.asarray(eager))
    index = parse_gwds(blob)
    assert list(index) == ["t", "rho"] and index["t"] == (12, vols["t"][0].nbytes)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_opens_the_others_envelope(vols, field, tmp_path, writer):
    path = tmp_path / "d.gwds"
    _write_streamed(writer, path, vols, field)
    roi = (slice(1, 7), slice(3, 13), slice(2, 8))
    with api.open(path, device=CPU) as ds, rapi.open(path) as rds:
        assert ds.fields == rds.fields == ("t", "rho") and len(ds) == 2
        assert ds.size_report() == rds.size_report() and ds.nbytes == rds.nbytes
        for name in ds:
            np.testing.assert_array_equal(np.asarray(ds[name]), np.asarray(rds[name]))
            np.testing.assert_array_equal(ds[name][roi], rds[name][roi])
        assert ds.to_bytes() == rds.to_bytes() == path.read_bytes()
        assert isinstance(ds["rho"].artifact.tile_blobs, api.LaneStore)


def test_from_bytes_and_save_roundtrip(vols, tmp_path):
    blob = api.Dataset.build({n: v for n, (v, _r) in vols.items()})
    ds = api.from_bytes(blob, device=CPU)
    assert isinstance(ds, api.Dataset) and set(ds.keys()) == {"t", "rho"}
    assert ds["t"].device.type == CPU and ds["rho"].tiled
    rep = ds.size_report()
    assert rep["fields"] == {"t": vols["t"][0].nbytes, "rho": vols["rho"][0].nbytes}
    assert rep["total"] == ds.nbytes == len(blob) and rep["index"] == len(blob) - sum(
        rep["fields"].values())
    with pytest.raises(KeyError):
        ds["nope"]
    assert api.save(tmp_path / "again.gwds", ds) == len(blob)  # a Dataset re-saves verbatim
    assert (tmp_path / "again.gwds").read_bytes() == blob
    assert "fields=['t', 'rho']" in repr(ds)


def test_dataset_entry_points_need_cuda_without_a_device(vols, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    blob = api.Dataset.build({"t": vols["t"][0]})
    (tmp_path / "d.gwds").write_bytes(blob)
    for call in (lambda: api.from_bytes(blob), lambda: api.open(tmp_path / "d.gwds"),
                 lambda: api.Dataset.from_bytes(blob)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# the golden v1 envelope
# ---------------------------------------------------------------------------


def test_golden_gwds_v1_opens():
    path = GOLDEN / "gwds_v1.bin"
    assert path.read_bytes()[4] == 1
    with api.open(path, device=CPU) as ds, rapi.open(path) as rds:
        assert ds.fields == rds.fields == ("temperature", "baryon_density")
        lorenzo = np.asarray(ds["baryon_density"])  # tiled Lorenzo: bit for bit
        want = np.load(GOLDEN / "gwds_v1_baryon_density_decode.npy")
        assert lorenzo.dtype == want.dtype and np.array_equal(lorenzo.view(np.uint32),
                                                              want.view(np.uint32))
        interp = np.asarray(ds["temperature"])  # SZJX interp: the reference's live decode
        live = np.asarray(rds["temperature"])
        tol = 8 * 2.0**-23 * float(np.abs(live).max())
        assert interp.shape == live.shape and float(np.abs(interp - live).max()) <= tol
        assert ds.size_report() == rds.size_report()


# ---------------------------------------------------------------------------
# errors: corrupt, truncated, duplicate, empty
# ---------------------------------------------------------------------------


def _corruptions(blob: bytes) -> dict:
    """case -> damaged envelope."""
    bad_index = bytearray(blob)
    bad_index[-16:-8] = (len(blob)).to_bytes(8, "little")  # index offset past the footer
    long_field = bytearray(blob)
    # the first entry's length (after u32 name_len, "t", u64 offset) runs past the index
    index_off = int.from_bytes(blob[-16:-8], "little")
    start = index_off + 4 + 1 + 8
    long_field[start:start + 8] = (len(blob)).to_bytes(8, "little")
    return {"cut_mid_header": blob[:6], "cut_mid_index": blob[:20],
            "cut_mid_payload": blob[:-50], "cut_footer": blob[:-3],
            "garbage_footer": blob[:-4] + b"XXXX", "bad_index_offset": bytes(bad_index),
            "field_past_payload": bytes(long_field),
            "bad_version": blob[:4] + b"\x07" + blob[5:],
            "garbage": b"GWDS" + bytes(range(60))}


@pytest.mark.parametrize("case", ["cut_mid_header", "cut_mid_index", "cut_mid_payload",
                                  "cut_footer", "garbage_footer", "bad_index_offset",
                                  "field_past_payload", "bad_version", "garbage"])
def test_damaged_envelopes_raise_in_both_packages(vols, case):
    blob = api.Dataset.build({n: v for n, (v, _r) in vols.items()})
    bad = _corruptions(blob)[case]
    with pytest.raises(CorruptContainerError) as port:
        api.from_bytes(bad, device=CPU)
    with pytest.raises(rapi.CorruptContainerError) as ref:
        rapi.from_bytes(bad)
    assert str(port.value) == str(ref.value)


def test_v1_field_past_the_blob_raises():
    blob = (GOLDEN / "gwds_v1.bin").read_bytes()
    for cut in (len(blob) - 10, 40):
        with pytest.raises(CorruptContainerError) as port:
            api.from_bytes(blob[:cut], device=CPU)
        with pytest.raises(rapi.CorruptContainerError) as ref:
            rapi.from_bytes(blob[:cut])
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("version", [1, 2])
def test_parse_gwds_reads_both_versions_as_the_reference(vols, version):
    """One parser reads the v1 index (after the header) and the v2 one (in
    the footer, as GWDSWriter writes it), from bytes or a memoryview."""
    if version == 1:
        blob = (GOLDEN / "gwds_v1.bin").read_bytes()
    else:
        blob = api.Dataset.build({n: v for n, (v, _r) in vols.items()})
    assert blob[4] == version
    index = parse_gwds(blob)
    assert index == rapi.Dataset.from_bytes(blob)._index and len(index) >= 2
    assert parse_gwds(memoryview(blob)) == index
    for fo, fl in index.values():
        assert api.from_bytes(blob[fo:fo + fl], device=CPU).shape


@pytest.mark.parametrize("pkg", list(PKGS))
def test_duplicate_empty_and_streaming_errors(vols, field, tmp_path, pkg):
    writer, _stream, _kw = PKGS[pkg]
    mono = vols["t"][0].to_bytes()
    w = writer(tmp_path / "a.gwds")
    with pytest.raises(ValueError, match="at least one field"):
        w.finalize()
    w2 = writer(tmp_path / "b.gwds")
    w2.add_field("t", mono)
    with pytest.raises(ValueError, match="duplicate GWDS field 't'"):
        w2.add_field("t", mono)
    gw = w2.stream_field("rho", shape=STREAM_SHAPE, tile=TILE, eb_abs=EB)
    with pytest.raises(ValueError, match="'rho' is still streaming; finalize it first"):
        w2.add_field("u", mono)
    with pytest.raises(ValueError, match="'rho' is still streaming"):
        w2.finalize()
    for _ in range(gw.n_tiles):
        gw.append_lane(b"lane")
    gw.finalize()
    w2.finalize()
    with pytest.raises(ValueError, match="already finalized"):
        w2.add_field("u", mono)
    with pytest.raises(ValueError, match="already finalized"):
        w2.finalize()
    api_mod = {"ref": rapi, "port": api}[pkg]
    with pytest.raises(ValueError, match="at least one field"):
        api_mod.Dataset.build({})
    with pytest.raises(TypeError, match="compress it first"):
        api_mod.save(tmp_path / "x", {"temperature": np.zeros((4, 4, 4))})
    with pytest.raises(TypeError):
        api_mod.save(tmp_path / "x", object())


def test_writer_context_manager(vols, tmp_path):
    mono = vols["t"][0].to_bytes()
    with GWDSWriter(tmp_path / "ok.gwds") as w:
        w.add_field("t", mono)
    assert (tmp_path / "ok.gwds").read_bytes() == api.Dataset.build({"t": vols["t"][0]})
    sink = io.BytesIO()
    with pytest.raises(KeyError):
        with GWDSWriter(sink) as w:
            w.add_field("t", mono)
            raise KeyError("boom")
    assert not sink.closed, "a caller's file object stays open"


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------


def test_close_releases_every_field(vols, tmp_path):
    path = tmp_path / "s.gwds"
    api.save(path, {n: v for n, (v, _r) in vols.items()})
    ds = api.open(path, device=CPU)
    mm = ds._resources[1]
    t, rho = ds["t"], ds["rho"]
    np.testing.assert_array_equal(rho[0:4], np.asarray(vols["rho"][0])[0:4])
    np.testing.assert_array_equal(np.asarray(t), np.asarray(vols["t"][0]))
    ds.close()
    assert mm.closed, "closing the dataset releases the mapping"
    with pytest.raises(ValueError, match="closed"):
        ds["t"]
    for vol in (t, rho):
        with pytest.raises(ValueError, match="closed"):
            vol[0:4]  # field handles close with their parent
    ds.close()  # idempotent
    with api.open(path, device=CPU, mmap=False) as ds2:
        assert ds2.fields == ("t", "rho") and ds2._resources == ()
    with pytest.raises(ValueError, match="closed"):
        ds2.__enter__()


# ---------------------------------------------------------------------------
# a shared sink fails fast
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", list(PKGS))
def test_shared_sink_has_no_rollback_and_fails_fast(field, tmp_path, pkg):
    writer, stream, kw = PKGS[pkg]
    fault = {"ref": rfault, "port": None}[pkg]
    inj = (fault.FailureInjector if fault else FailureInjector)({1}, exc=OSError)
    retry = (fault.RetryPolicy if fault else RetryPolicy)(max_attempts=3, backoff=0.0)
    x = np.ascontiguousarray(field[: STREAM_SHAPE[0], : STREAM_SHAPE[1], : STREAM_SHAPE[2]])
    w = writer(tmp_path / "f.gwds")
    gw = w.stream_field("rho", shape=x.shape, tile=TILE, eb_abs=EB)
    assert gw.can_rollback is False
    with pytest.raises(ValueError, match="shared sink"):
        gw.rollback_uncommitted()
    with pytest.raises(ValueError, match="shared sink"):
        gw.truncate_lanes(0)
    with pytest.raises(OSError, match="injected failure at step 1"):
        stream(x, gw, **STREAM_KW, retry=retry, write_injector=inj, **kw)
    assert inj.failed == {1: 1}, "one attempt: no retry on a shared sink"


def test_shared_sink_footer_offsets_are_container_relative(vols, field, tmp_path):
    """A streamed field's GWTC footer counts from the field's first byte,
    not the envelope's: the field parses on its own."""
    _write_streamed("port", tmp_path / "d.gwds", vols, field)
    blob = (tmp_path / "d.gwds").read_bytes()
    fo, fl = parse_gwds(blob)["rho"]
    assert fo == 12 + vols["t"][0].nbytes
    vol = api.from_bytes(blob[fo:fo + fl], device=CPU)
    assert vol.tiled and vol.shape == STREAM_SHAPE


# ---------------------------------------------------------------------------
# the CLI's --field, and serve on a dataset
# ---------------------------------------------------------------------------


def _code(main, argv) -> int:
    try:
        return int(main(argv) or 0)
    except SystemExit as e:
        return int(e.code or 0)


@pytest.mark.parametrize("argv", [
    ["decompress", "{d}", "{o}", "--field", "t"],
    ["decompress", "{d}", "{o}"],
    ["decompress", "{d}", "{o}", "--field", "nope"],
    ["decompress", "{m}", "{o}", "--field", "t"],
    ["decompress", "{one}", "{o}"],
    ["region", "{d}", "--roi", "0:4,2:9,:", "--field", "rho"],
    ["region", "{d}", "--roi", "0:4,2:9,:"],
    ["region", "{d}", "--roi", "0:4", "--field", "nope"],
    ["region", "{m}", "--roi", "0:4", "--field", "t"],
    ["verify", "{d}"],
    ["verify", "{d}", "--field", "rho"],
    ["verify", "{d}", "--field", "nope"],
    ["verify", "{m}", "--field", "t"],
    ["verify", "{bad}"],
    ["verify", "{bad}", "--field", "t"],
    ["info", "{d}"],
], ids=lambda a: "_".join(t.strip("{}-") for t in a).replace(",", "").replace(":", ""))
def test_cli_field_exit_codes_equal_the_reference(vols, tmp_path, argv, capsys):
    from repro_torch.sz import tiled

    d, m, one, bad = (tmp_path / n for n in ("d.gwds", "m.szjx", "one.gwds", "bad.gwds"))
    api.save(d, {n: v for n, (v, _r) in vols.items()})
    api.save(m, vols["t"][0])
    api.save(one, {"only": vols["t"][0]})
    blob = bytearray(d.read_bytes())
    fo, _fl = parse_gwds(bytes(blob))["rho"]
    blob[fo + tiled.lane_offset(vols["rho"][0].artifact, 0) + 5] ^= 0x10  # one lane byte
    bad.write_bytes(bytes(blob))
    args = [a.format(d=d, m=m, one=one, bad=bad, o=tmp_path / "o.npy") for a in argv]
    got = _code(cli.main, ["--device", CPU, *args])
    port_out = capsys.readouterr()
    out_npy = tmp_path / "o.npy"
    port_file = np.load(out_npy) if out_npy.exists() else None
    if out_npy.exists():
        out_npy.unlink()
    want = _code(rcli.main, args)
    ref_out = capsys.readouterr()
    assert got == want, (port_out.err, ref_out.err)
    if port_file is not None:
        np.testing.assert_array_equal(port_file, np.load(out_npy))
    if want == 0 and argv[0] != "info":
        assert port_out.out == ref_out.out
    for msg in ("pick one with --field", "no field", "--field only applies", "CORRUPT"):
        assert (msg in port_out.err) == (msg in ref_out.err)
    if argv[0] == "info":
        assert port_out.out.splitlines()[0] == ref_out.out.splitlines()[0]
        assert port_out.out.startswith("GWDS dataset: 2 fields")


def test_cli_info_and_verify_print_every_field(vols, tmp_path, capsys):
    d = tmp_path / "d.gwds"
    api.save(d, {n: v for n, (v, _r) in vols.items()})
    assert cli.main(["--device", CPU, "info", str(d)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("  t: CompressedVolume(SZJX") and out[2].startswith(
        "  rho: CompressedVolume(GWTC tiled")
    assert cli.main(["--device", CPU, "verify", str(d)]) == 0
    lanes = vols["rho"][0].artifact.n_tiles
    assert capsys.readouterr().out.splitlines() == [
        "ok: field 't' (1 lanes)", f"ok: field 'rho' ({lanes} lanes)"]
