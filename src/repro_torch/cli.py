"""Shell front door over the ``repro_torch.api`` façade, port of
``repro/cli.py``.

    python -m repro_torch.cli [--device cuda|cpu] compress IN OUT
                              [--eb 1e-3 | --abs-eb X] [--tiled] [--tile 32]
                              [--predictor interp|lorenzo] [--order linear|cubic]
                              [--backend ...] [--enhance --groups 8 --epochs 60]
                              [--stream [--mem-budget 256M] [--resume] [--retries 3]]
    python -m repro_torch.cli decompress IN OUT.npy [--field NAME]
    python -m repro_torch.cli info       PATH
    python -m repro_torch.cli region     PATH --roi "8:40,:,16:32" [--out OUT.npy]
                              [--field NAME]
    python -m repro_torch.cli verify     PATH [--field NAME]
    python -m repro_torch.cli serve      [NAME=]PATH ... [--port 8177]
                              [--cache-bytes 256M] [--mem-budget 256M]
                              [--on-corrupt raise|quarantine] [--batch-wait-ms 2]
                              [--no-batcher] [--smoke]
    python -m repro_torch.cli lint       [--json] [--rule RAnnn ...] [--root DIR]
                              [--baseline PATH [--write-baseline]]

``compress IN`` takes a ``.npy`` volume, or ``synthetic:<field>[:<side>]``
(e.g. ``synthetic:temperature:24``) for a generated Nyx-like field (seed 1,
as the reference CLI makes it).  ``verify`` checks a container end to end
(envelope structure, metadata checksum and every lane CRC) and exits
nonzero on the first corruption.  Every subcommand works on whatever
envelope ``api.open`` sniffs (``SZJX``/``GWTC``/``GWDS``); ``--field``
picks one field of a multi-field ``GWDS`` dataset (needed when it has more
than one; ``verify`` without it checks every field).  ``--predictor`` is
interp (the default, as in the reference) or lorenzo.  Files are
byte-identical to the reference CLI's for the Lorenzo predictor; interp
files open in either package (``sz/predictor.py`` states the port's float32
arithmetic).

``--device`` (before the subcommand) picks where the work runs: ``cuda``
(the default, the port's kernels; no card is an error) or ``cpu`` (their
plain PyTorch versions).

``compress --stream`` is the out-of-core path (``api.compress_stream``): a
``.npy`` input streams off its memmap in tile batches sized against
``--mem-budget`` into a GWTC container, journaled as it goes;
``--resume`` continues an interrupted ``--stream`` run from its commit
journal (``<output>.journal``), and ``--retries`` sets the attempts per
batch for transient faults.

``serve`` runs the multi-tenant region-decode daemon (``repro_torch.serve``)
over the named volumes behind one shared tile cache, decoding on
``--device``; ``--smoke`` exercises every endpoint over HTTP and exits.  A
GWDS dataset is not a volume: ``serve`` refuses one (exit 2).

``lint`` runs the AST static-analysis suite (``repro_torch.analysis``,
RA001-RA005, docs/ANALYSIS.md) over the ``repro_torch`` tree: 0 clean, 1
findings.  It reads source text only: no device, no tensor, and
``--device`` does not apply.

Exit codes are uniform across subcommands: **0** success, **1** integrity
failure (corrupt container / failed CRC), **2** usage error (bad
arguments, missing files or fields, invalid ROI, no CUDA device).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from repro_torch import api

EXIT_OK = 0
EXIT_INTEGRITY = 1
EXIT_USAGE = 2


def _fail(what: str, msg, code: int = EXIT_USAGE) -> SystemExit:
    """Print a clean one-line error and return the SystemExit to raise."""
    print(f"{what}: {msg}", file=sys.stderr)
    return SystemExit(code)


def _device(args, what: str):
    """``--device`` for the façade: ``cuda`` means the default device, which
    must exist."""
    from repro_torch.kernels.ops import resolve_device

    try:
        return resolve_device(None if args.device == "cuda" else args.device)
    except RuntimeError as e:
        raise _fail(what, f"{e} (use --device cpu)") from None


def _open(path, what: str, args, **kw):
    """api.open with CLI-grade errors: missing or unreadable files are usage
    errors (exit 2), corrupt containers integrity errors (exit 1)."""
    try:
        return api.open(path, device=_device(args, what), **kw)
    except OSError as e:
        raise _fail(what, f"cannot open {path!r}: {e.strerror or e}")
    except api.IntegrityError as e:
        print(f"CORRUPT: {e}", file=sys.stderr)
        raise SystemExit(EXIT_INTEGRITY) from None


def _select(obj, field: str | None, what: str):
    """Resolve api.open output (and an optional --field) to one volume
    handle."""
    if isinstance(obj, api.Dataset):
        if field is None:
            if len(obj) == 1:
                return obj[next(iter(obj))]
            raise _fail(what, f"GWDS dataset has fields {list(obj)}; pick one with --field")
        if field not in obj:
            raise _fail(what, f"no field {field!r} in dataset (fields: {list(obj)})")
        return obj[field]
    if field is not None:
        raise _fail(what, "--field only applies to GWDS datasets")
    return obj


def parse_size(text: str) -> int:
    """'256M' / '64K' / '2G' / '1048576' -> bytes."""
    t = text.strip().upper().removesuffix("B")
    mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}.get(t[-1:] or "", None)
    if mult is not None:
        t = t[:-1]
    try:
        return int(float(t) * (mult or 1))
    except ValueError:
        raise ValueError(f"bad size {text!r} (expected e.g. 256M, 64K, 1G)") from None


def parse_roi(text: str) -> tuple:
    """'8:40,:,16:32' -> tuple of slices/ints (start:stop:step per axis)."""
    out = []
    for tok in text.split(","):
        tok = tok.strip()
        if ":" in tok:
            parts = [p.strip() for p in tok.split(":")]
            if len(parts) > 3:
                raise ValueError(f"bad roi axis {tok!r}")
            vals = [int(p) if p else None for p in parts] + [None] * (3 - len(parts))
            out.append(slice(*vals))
        elif tok:
            out.append(int(tok))
        else:
            raise ValueError(f"empty roi axis in {text!r}")
    return tuple(out)


def _load_volume(spec: str) -> np.ndarray:
    if spec.startswith("synthetic:"):
        parts = spec.split(":")
        field = parts[1] if len(parts) > 1 and parts[1] else "temperature"
        side = int(parts[2]) if len(parts) > 2 else 32
        from repro_torch.data import nyx_like_field

        return np.asarray(nyx_like_field((side,) * 3, field, seed=1))
    try:
        return np.load(spec)
    except OSError as e:
        raise _fail("compress", f"cannot load {spec!r}: {e}") from None


def _stream(args, enhance, device) -> int:
    """``compress --stream``: .npy paths stream straight off the memmap;
    synthetic fields are generated in memory (they exist for smoke tests,
    not scale)."""
    try:
        budget = parse_size(args.mem_budget)
    except ValueError as e:
        raise _fail("compress", e) from None
    from repro_torch.exec import as_source
    from repro_torch.runtime.fault import RetryPolicy

    source = args.input if args.input.endswith(".npy") else _load_volume(args.input)
    try:
        src = as_source(source)
    except OSError as e:
        raise _fail("compress", f"cannot load {args.input!r}: {e}") from None
    retry = None if args.retries is None else RetryPolicy(max_attempts=max(1, args.retries))
    rep = api.compress_stream(
        src, args.output, eb=args.eb, abs_eb=args.abs_eb, tile=(args.tile,) * len(src.shape),
        mem_budget=budget, predictor=args.predictor, order=args.order, backend=args.backend,
        enhance=enhance, resume=args.resume, retry=retry, device=device)
    raw = int(np.prod(rep.shape)) * 4
    fault = ""
    if rep.retries:
        fault = (f"; {rep.retries} retr{'y' if rep.retries == 1 else 'ies'} on batches "
                 f"{list(rep.failed_batches)}")
    if rep.resumed_batches:
        fault += f"; resumed past {rep.resumed_batches} committed batches"
    print(f"streamed {args.output}: {rep.nbytes} bytes (cr {raw / rep.nbytes:.1f}x) in "
          f"{rep.n_batches} batches of {rep.batch_tiles} tiles; peak "
          f"{rep.peak_tracked_bytes / 2**20:.1f} MiB tracked of "
          f"{rep.mem_budget / 2**20:.1f} MiB budget"
          + (", enhanced" if rep.enhanced else "") + fault)
    return EXIT_OK


def cmd_compress(args) -> int:
    if args.resume and not args.stream:
        raise _fail("compress", "--resume requires --stream")
    device = _device(args, "compress")
    enhance: bool | object = False
    if args.enhance:
        from repro_torch.core.trainer import GWLZTrainConfig

        enhance = GWLZTrainConfig(n_groups=args.groups, epochs=args.epochs,
                                  min_group_pixels=args.min_group_pixels)
    if args.stream:
        return _stream(args, enhance, device)
    x = _load_volume(args.input)
    vol = api.compress(x, eb=args.eb, abs_eb=args.abs_eb, tiled=args.tiled,
                       tile=(args.tile,) * x.ndim, enhance=enhance,
                       predictor=args.predictor, order=args.order,
                       backend=args.backend, device=device)
    n = api.save(args.output, vol)
    print(f"wrote {args.output}: {n} bytes ({vol!r}, cr {x.nbytes / n:.1f}x)")
    if vol.train_stats is not None:
        s = vol.train_stats
        print(f"enhanced: PSNR {s.psnr_sz:.2f} -> {s.psnr_gwlz:.2f} dB "
              f"(overhead {s.overhead:.4f}x)")
    return EXIT_OK


def cmd_decompress(args) -> int:
    vol = _select(_open(args.input, "decompress", args), args.field, "decompress")
    try:
        arr = np.asarray(vol)
    except api.IntegrityError as e:
        print(f"CORRUPT: {e}", file=sys.stderr)
        return EXIT_INTEGRITY
    np.save(args.output, arr)
    print(f"wrote {args.output}: shape {arr.shape} dtype {arr.dtype} "
          f"(eb_abs {vol.eb_abs:.4g})")
    return EXIT_OK


def cmd_info(args) -> int:
    vol = _open(args.path, "info", args)
    if isinstance(vol, api.Dataset):
        print(f"GWDS dataset: {len(vol)} fields, {vol.nbytes} bytes "
              f"(index {vol.size_report()['index']} B)")
        for name in vol:
            print(f"  {name}: {vol[name]!r}")
        return EXIT_OK
    print(repr(vol))
    art = vol.artifact
    if vol.tiled:
        print(f"  tile {art.tile} grid {art.grid} ({art.n_tiles} lanes), "
              f"predictor {art.predictor}, backend {art.backend}")
    else:
        print(f"  predictor {art.predictor}, order {art.order}, levels {art.levels}")
    for k, v in vol.size_report().items():
        print(f"  {k}: {v}")
    return EXIT_OK


def cmd_region(args) -> int:
    vol = _select(_open(args.path, "region", args), args.field, "region")
    try:
        roi = parse_roi(args.roi)
    except ValueError as e:
        raise _fail("region", f"bad --roi {args.roi!r}: {e}") from None
    try:
        lanes, total = api.region_lane_count(vol, roi)
        block = vol[roi]
    except api.IntegrityError as e:
        print(f"CORRUPT: {e}", file=sys.stderr)
        return EXIT_INTEGRITY
    except (IndexError, ValueError) as e:
        raise _fail("region", f"--roi {args.roi!r} invalid for shape {vol.shape}: "
                              f"{e}") from None
    rng = f"min {block.min():.5g} max {block.max():.5g}" if block.size else "empty"
    print(f"roi {args.roi} -> shape {block.shape}, decoded {lanes}/{total} lanes, {rng}")
    if args.out:
        np.save(args.out, block)
        print(f"wrote {args.out}")
    return EXIT_OK


def cmd_verify(args) -> int:
    with _open(args.path, "verify", args, verify="full") as vol:
        if isinstance(vol, api.Dataset):
            return _verify_fields(vol, args.field)
        if args.field is not None:
            raise _fail("verify", "--field only applies to GWDS datasets")
        art = vol.artifact
        if not vol.tiled:
            note = "monolithic SZJX: no per-lane checksums; structural checks only"
        elif art.lane_crcs is not None:
            note = f"{art.n_tiles} lane CRCs checked"
        else:
            note = "no per-lane checksums (pre-checksum container); structural checks only"
        print(f"ok: {args.path} ({note})")
    return EXIT_OK


def _verify_fields(ds, field: str | None) -> int:
    """verify on a GWDS dataset: every field (or the one --field names)
    parses and checks every lane CRC."""
    name = None
    try:
        for name in [field] if field else list(ds):
            if name not in ds:
                raise _fail("verify", f"no field {name!r} in dataset (fields: {list(ds)})")
            vol = ds[name]  # field parse + full lane verification
            lanes = vol.stats.tiles_total if vol.tiled else 1
            print(f"ok: field {name!r} ({lanes} lanes)")
    except api.IntegrityError as e:
        print(f"CORRUPT: field {name!r}: {e}", file=sys.stderr)
        return EXIT_INTEGRITY
    return EXIT_OK


def cmd_serve(args) -> int:
    from repro_torch import serve as _serve

    volumes: dict[str, str] = {}
    for spec in args.volumes:
        name, sep, path = spec.partition("=")
        if not sep:  # default name: the file stem ("nyx.gwtc" -> "nyx")
            path = spec
            name = os.path.splitext(os.path.basename(path))[0]
        if not name:
            raise _fail("serve", f"empty volume name in {spec!r}")
        if name in volumes:
            raise _fail("serve", f"duplicate volume name {name!r} "
                                 "(use NAME=PATH to disambiguate)")
        volumes[name] = path
    try:
        cache_bytes = parse_size(args.cache_bytes)
        mem_budget = parse_size(args.mem_budget)
    except ValueError as e:
        raise _fail("serve", e) from None
    device = _device(args, "serve")
    try:
        server = _serve.RegionServer(
            volumes, host=args.host, port=args.port, cache_bytes=cache_bytes,
            mem_budget=mem_budget, max_queue=args.max_queue, on_corrupt=args.on_corrupt,
            batch_wait_ms=None if args.no_batcher else args.batch_wait_ms, device=device)
    except OSError as e:
        raise _fail("serve", f"cannot start: {e.strerror or e}") from None
    except api.IntegrityError as e:
        print(f"CORRUPT: {e}", file=sys.stderr)
        return EXIT_INTEGRITY
    except ValueError as e:  # a GWDS dataset is not a volume
        raise _fail("serve", e) from None
    with server:
        print(f"serving {sorted(server.pool.names)} on {server.url} "
              f"(cache {cache_bytes >> 20} MiB, budget {mem_budget >> 20} MiB, "
              f"device {device})", flush=True)
        if args.smoke:
            return _serve_smoke(server)
        try:
            server._thread.join()
        except KeyboardInterrupt:
            print("shutting down", file=sys.stderr)
        return EXIT_OK


def _serve_smoke(server) -> int:
    """--smoke: exercise every endpoint over real HTTP from this process (a
    repeated ROI must be served from the shared cache), then exit."""
    from repro_torch.serve import fetch_json, fetch_region

    url = server.url
    assert fetch_json(url, "/healthz")["status"] == "ok"
    name = sorted(server.pool.names)[0]
    info = fetch_json(url, f"/v/{name}/info")
    hi = min(8, info["shape"][0])
    roi = f"0:{hi}" + ",:" * (len(info["shape"]) - 1)
    a, _meta1 = fetch_region(url, name, roi)
    b, meta2 = fetch_region(url, name, roi)  # identical ROI: the cache must hit
    if not np.array_equal(a, b):
        print("smoke: repeated ROI decoded differently", file=sys.stderr)
        return EXIT_INTEGRITY
    m = fetch_json(url, "/metrics")
    hit_rate = m["cache"]["hit_rate"]
    if not hit_rate > 0:
        print(f"smoke: expected cache hits on a repeated ROI, got {m['cache']}",
              file=sys.stderr)
        return EXIT_INTEGRITY
    print(f"smoke ok: {meta2['lanes']}/{meta2['lanes_total']} lanes, hit_rate "
          f"{hit_rate:.2f}, p99 {m['latency_ms'].get('p99', 0):.1f} ms over "
          f"{m['requests']} requests")
    return EXIT_OK


def cmd_lint(args) -> int:
    from pathlib import Path

    from repro_torch.analysis import run_analysis
    from repro_torch.analysis.engine import all_rules, default_root
    from repro_torch.analysis.report import (apply_baseline, load_baseline, render_json,
                                             render_text)

    root = Path(args.root).resolve() if args.root else default_root()
    try:
        findings = run_analysis(root=root, rules=args.rule or None)
    except ValueError as e:
        raise _fail("lint", e) from None
    rules = list(dict.fromkeys(args.rule)) if args.rule else sorted(all_rules())
    files = sum(1 for p in root.rglob("*.py") if "__pycache__" not in p.parts)

    if args.baseline and args.write_baseline:
        Path(args.baseline).write_text(render_json(
            findings, root=str(root), files=files, rules=rules) + "\n")
        print(f"lint: wrote baseline with {len(findings)} finding(s) to {args.baseline}",
              file=sys.stderr)
        return EXIT_OK
    if args.write_baseline:
        raise _fail("lint", "--write-baseline needs --baseline PATH")
    if args.baseline:
        try:
            accepted = load_baseline(Path(args.baseline).read_text())
        except (OSError, ValueError, KeyError, TypeError) as e:
            raise _fail("lint", f"cannot read baseline {args.baseline!r}: {e}") from None
        findings = apply_baseline(findings, accepted)

    render = render_json if args.json else render_text
    print(render(findings, root=str(root), files=files, rules=rules))
    return EXIT_INTEGRITY if findings else EXIT_OK


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.cli", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run: cuda (default) or cpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="compress a .npy (or synthetic:) volume")
    c.add_argument("input", help=".npy path or synthetic:<field>[:<side>]")
    c.add_argument("output")
    c.add_argument("--eb", type=float, default=None, help="relative error bound")
    c.add_argument("--abs-eb", type=float, default=None, help="absolute error bound")
    c.add_argument("--tiled", action="store_true", help="GWTC tiled container")
    c.add_argument("--tile", type=int, default=64, help="tile side (tiled only)")
    c.add_argument("--predictor", default="interp", choices=["interp", "lorenzo"])
    c.add_argument("--order", default="cubic", choices=["linear", "cubic"])
    c.add_argument("--backend", default="huffman+zlib",
                   choices=["zlib", "huffman", "huffman+zlib"])
    c.add_argument("--stream", action="store_true",
                   help="bounded-memory out-of-core compress (GWTC container)")
    c.add_argument("--mem-budget", default="256M",
                   help="streaming byte budget, e.g. 64M / 512K / 1G")
    c.add_argument("--resume", action="store_true",
                   help="continue an interrupted --stream run from its commit journal "
                        "(<output>.journal)")
    c.add_argument("--retries", type=int, default=None,
                   help="per-batch retry attempts for transient faults (default: 3)")
    c.add_argument("--enhance", action="store_true",
                   help="train + attach group-wise GWLZ enhancers"
                        " (streamed runs train on a reservoir tile sample)")
    c.add_argument("--groups", type=int, default=8)
    c.add_argument("--epochs", type=int, default=60)
    c.add_argument("--min-group-pixels", type=int, default=256)
    c.set_defaults(fn=cmd_compress)

    d = sub.add_parser("decompress", help="full decode to a .npy file")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--field", default=None, help="field name (GWDS datasets)")
    d.set_defaults(fn=cmd_decompress)

    i = sub.add_parser("info", help="envelope + size breakdown")
    i.add_argument("path")
    i.set_defaults(fn=cmd_info)

    r = sub.add_parser("region", help="random-access ROI decode")
    r.add_argument("path")
    r.add_argument("--roi", required=True, help='e.g. "8:40,:,16:32"')
    r.add_argument("--out", default=None, help="write the ROI to a .npy file")
    r.add_argument("--field", default=None, help="field name (GWDS datasets)")
    r.set_defaults(fn=cmd_region)

    v = sub.add_parser("verify", help="end-to-end integrity check "
                                      "(structure + metadata + lane CRCs)")
    v.add_argument("path")
    v.add_argument("--field", default=None, help="field name (GWDS datasets)")
    v.set_defaults(fn=cmd_verify)

    s = sub.add_parser("serve", help="multi-tenant region-decode daemon (docs/SERVING.md)")
    s.add_argument("volumes", nargs="+", metavar="[NAME=]PATH",
                   help="volumes to serve (default name: the file stem)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8177,
                   help="listen port (0 binds an ephemeral port)")
    s.add_argument("--cache-bytes", default="256M",
                   help="shared decoded-tile cache budget, e.g. 64M / 1G")
    s.add_argument("--mem-budget", default="256M",
                   help="admission-control working-set budget")
    s.add_argument("--max-queue", type=int, default=1024,
                   help="max requests waiting on admission before 503")
    s.add_argument("--on-corrupt", default="raise", choices=["raise", "quarantine"],
                   help="per-lane CRC failure policy for served volumes")
    s.add_argument("--batch-wait-ms", type=float, default=2.0,
                   help="decode micro-batcher max wait: how long the first request of a "
                        "round holds the decode open for concurrent requests to join")
    s.add_argument("--no-batcher", action="store_true",
                   help="disable cross-request decode batching (each request decodes "
                        "its own claimed lanes)")
    s.add_argument("--smoke", action="store_true",
                   help="start, exercise every endpoint over HTTP (asserting cache hits "
                        "on a repeated ROI), then exit")
    s.set_defaults(fn=cmd_serve)

    lint = sub.add_parser("lint", help="AST static-analysis gate over the repro_torch tree "
                                       "(docs/ANALYSIS.md)")
    lint.add_argument("--json", action="store_true",
                      help="machine-readable report (the reference's JSON shape)")
    lint.add_argument("--rule", action="append", metavar="RAnnn",
                      help="run only these rule ids (repeatable)")
    lint.add_argument("--root", default=None,
                      help="tree to analyze (default: the installed repro_torch package "
                           "-- src/repro_torch in a checkout)")
    lint.add_argument("--baseline", default=None, metavar="PATH",
                      help="JSON report of accepted findings to subtract")
    lint.add_argument("--write-baseline", action="store_true",
                      help="write current findings to --baseline and exit 0")
    lint.set_defaults(fn=cmd_lint)

    args = ap.parse_args(argv)
    if args.cmd == "compress" and (args.eb is None) == (args.abs_eb is None):
        ap.error("pass exactly one of --eb / --abs-eb")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
