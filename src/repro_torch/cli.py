"""Shell front door over the ``repro_torch.api`` façade, port of
``repro/cli.py``.

    python -m repro_torch.cli [--device cuda|cpu] compress IN OUT
                              [--eb 1e-3 | --abs-eb X] [--tiled] [--tile 32]
                              [--predictor interp|lorenzo] [--order linear|cubic]
                              [--backend ...] [--enhance --groups 8 --epochs 60]
    python -m repro_torch.cli decompress IN OUT.npy
    python -m repro_torch.cli info       PATH
    python -m repro_torch.cli region     PATH --roi "8:40,:,16:32" [--out OUT.npy]
    python -m repro_torch.cli verify     PATH

``compress IN`` takes a ``.npy`` volume, or ``synthetic:<field>[:<side>]``
(e.g. ``synthetic:temperature:24``) for a generated Nyx-like field (seed 1,
as the reference CLI makes it).  ``verify`` checks a container end to end
(envelope structure, metadata checksum and every lane CRC) and exits
nonzero on the first corruption.  Every subcommand works on whatever
envelope ``api.open`` sniffs (``SZJX``/``GWTC``).  Files are byte-identical
to the reference CLI's for the Lorenzo predictor.

``--device`` (before the subcommand) picks where the work runs: ``cuda``
(the default, the port's kernels; no card is an error) or ``cpu`` (their
plain PyTorch versions).

Not ported yet: the interp predictor (the default of ``--predictor``,
ROADMAP.md Queue 1 item 6), ``--stream``/``--resume`` (item 7), GWDS
datasets and ``--field`` (item 9), and the ``serve``/``lint`` commands.

Exit codes are uniform across subcommands: **0** success, **1** integrity
failure (corrupt container / failed CRC), **2** usage error (bad
arguments, missing files, invalid ROI, no CUDA device, a part not ported).
"""
from __future__ import annotations

import argparse
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
    """api.open with CLI-grade errors: missing or unreadable files and parts
    not ported are usage errors (exit 2), corrupt containers integrity
    errors (exit 1)."""
    try:
        return api.open(path, device=_device(args, what), **kw)
    except OSError as e:
        raise _fail(what, f"cannot open {path!r}: {e.strerror or e}")
    except api.IntegrityError as e:
        print(f"CORRUPT: {e}", file=sys.stderr)
        raise SystemExit(EXIT_INTEGRITY) from None
    except NotImplementedError as e:
        raise _fail(what, e) from None


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


def cmd_compress(args) -> int:
    if args.stream or args.resume:
        raise _fail("compress", "--stream/--resume: streaming compression is not ported "
                                "yet (ROADMAP.md Queue 1 item 7)")
    device = _device(args, "compress")
    enhance: bool | object = False
    if args.enhance:
        from repro_torch.core.trainer import GWLZTrainConfig

        enhance = GWLZTrainConfig(n_groups=args.groups, epochs=args.epochs,
                                  min_group_pixels=args.min_group_pixels)
    x = _load_volume(args.input)
    try:
        vol = api.compress(x, eb=args.eb, abs_eb=args.abs_eb, tiled=args.tiled,
                           tile=(args.tile,) * x.ndim, enhance=enhance,
                           predictor=args.predictor, order=args.order,
                           backend=args.backend, device=device)
    except NotImplementedError as e:
        raise _fail("compress", e) from None
    n = api.save(args.output, vol)
    print(f"wrote {args.output}: {n} bytes ({vol!r}, cr {x.nbytes / n:.1f}x)")
    if vol.train_stats is not None:
        s = vol.train_stats
        print(f"enhanced: PSNR {s.psnr_sz:.2f} -> {s.psnr_gwlz:.2f} dB "
              f"(overhead {s.overhead:.4f}x)")
    return EXIT_OK


def cmd_decompress(args) -> int:
    vol = _open(args.input, "decompress", args)
    try:
        arr = np.asarray(vol)
    except api.IntegrityError as e:
        print(f"CORRUPT: {e}", file=sys.stderr)
        return EXIT_INTEGRITY
    except NotImplementedError as e:
        raise _fail("decompress", e) from None
    np.save(args.output, arr)
    print(f"wrote {args.output}: shape {arr.shape} dtype {arr.dtype} "
          f"(eb_abs {vol.eb_abs:.4g})")
    return EXIT_OK


def cmd_info(args) -> int:
    vol = _open(args.path, "info", args)
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
    vol = _open(args.path, "region", args)
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
    except NotImplementedError as e:
        raise _fail("region", e) from None
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
        art = vol.artifact
        if not vol.tiled:
            note = "monolithic SZJX: no per-lane checksums; structural checks only"
        elif art.lane_crcs is not None:
            note = f"{art.n_tiles} lane CRCs checked"
        else:
            note = "no per-lane checksums (pre-checksum container); structural checks only"
        print(f"ok: {args.path} ({note})")
    return EXIT_OK


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
                   help="bounded-memory out-of-core compress (not ported yet)")
    c.add_argument("--resume", action="store_true",
                   help="continue an interrupted --stream run (not ported yet)")
    c.add_argument("--enhance", action="store_true",
                   help="train + attach group-wise GWLZ enhancers")
    c.add_argument("--groups", type=int, default=8)
    c.add_argument("--epochs", type=int, default=60)
    c.add_argument("--min-group-pixels", type=int, default=256)
    c.set_defaults(fn=cmd_compress)

    d = sub.add_parser("decompress", help="full decode to a .npy file")
    d.add_argument("input")
    d.add_argument("output")
    d.set_defaults(fn=cmd_decompress)

    i = sub.add_parser("info", help="envelope + size breakdown")
    i.add_argument("path")
    i.set_defaults(fn=cmd_info)

    r = sub.add_parser("region", help="random-access ROI decode")
    r.add_argument("path")
    r.add_argument("--roi", required=True, help='e.g. "8:40,:,16:32"')
    r.add_argument("--out", default=None, help="write the ROI to a .npy file")
    r.set_defaults(fn=cmd_region)

    v = sub.add_parser("verify", help="end-to-end integrity check "
                                      "(structure + metadata + lane CRCs)")
    v.add_argument("path")
    v.set_defaults(fn=cmd_verify)

    args = ap.parse_args(argv)
    if args.cmd == "compress" and (args.eb is None) == (args.abs_eb is None):
        ap.error("pass exactly one of --eb / --abs-eb")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
