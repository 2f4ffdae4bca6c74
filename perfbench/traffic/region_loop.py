"""Closed-loop random-access reader: set-up streams the field of the run's
seed from host memory into a journaled file with the configuration's
``api.compress_stream`` call and reads ``warmup_reads`` boxes of it on a
handle of its own; then one client reads box after box,
``np.asarray(vol[z0:z1, y0:y1, x0:x1])``, on one handle (``api.open``, a
tile cache of ``cache_bytes``) opened for the window.  A
box's sides are uniform in [``side_min``, ``side_max``] (at most the
field's), its corner uniform over the places it fits, all from the seed.

Mix parameters: ``side_min``, ``side_max``, ``warmup_reads``,
``cache_bytes``, ``keep_share`` (the share of reads, drawn from the seed,
whose output the check holds against the reference, besides the first).
"""
from __future__ import annotations

import gc
import os

import numpy as np
import torch

from perfbench import loop as L
from perfbench import reference as R
from perfbench import streaming as S
from perfbench.reference import region as RR


def _box(run, rng) -> tuple:
    lo, hi = run.mix["side_min"], run.mix["side_max"]
    sides = [min(int(rng.integers(lo, hi + 1)), d) for d in run.cfg["shape"]]
    return tuple((c, c + s) for c, s in
                 ((int(rng.integers(0, d - s + 1)), s) for d, s in zip(run.cfg["shape"], sides)))


def _slices(box) -> tuple:
    return tuple(slice(a, b) for a, b in box)


def setup(run) -> None:
    x = L.field(run, run.seed)
    xh = x.cpu().numpy()
    del x
    path = os.path.join(S.io_dir(run), "field.gwtc")
    _rec, blob = S.stream_file(run, xh, path)
    run.state.update(x=xh, blob=blob)
    with run.api.open(path, cache_bytes=run.mix["cache_bytes"], device=run.device) as vol:
        rng = np.random.default_rng([run.seed, 5])
        for _ in range(run.mix["warmup_reads"]):
            np.asarray(vol[_slices(_box(run, rng))])
    # the window's handle opens cold, so its first read (the one a traced
    # run profiles) decodes on the device
    run.state["vol"] = run.api.open(path, cache_bytes=run.mix["cache_bytes"], device=run.device)


def window(run) -> None:
    vol = run.state["vol"]
    boxes, keep = np.random.default_rng([run.seed, 4]), np.random.default_rng([run.seed, 2])
    kept = run.state["kept"] = {}
    run.state["boxes"] = {}

    def op(i):
        box = _box(run, boxes)
        out = np.asarray(vol[_slices(box)])
        if i == 0 or keep.random() < run.mix["keep_share"]:
            kept[i] = out
            run.state["boxes"][i] = box
        return {"raw": out.nbytes, "box": box}

    L.closed_loop(run, op)


def release(run) -> None:
    vol = run.state.pop("vol", None)
    if vol is not None:
        vol.close()
    S.remove_io_dir(run)
    gc.collect()
    if run.device != "cpu":
        torch.cuda.empty_cache()


def check(run) -> list:
    """The reference decodes, enhances and crops only the tiles the kept
    boxes touch; every kept output must equal its box to the limit
    (``gap_eb``), and those tiles' codes and lane CRCs must be the input's.
    An output of the whole field's shape stands for a reader that decoded
    the field whole (perfbench/control.py's stand-in): its box is cropped
    from it."""
    x = torch.from_numpy(run.state["x"]).to(run.device)
    eb = R.rel_eb_abs(x, run.cfg["rel_eb"])
    boxes = run.state["boxes"]
    tile, shape = run.cfg["tile"], run.cfg["shape"]
    grid = [-(-d // t) for d, t in zip(shape, tile)]
    ids = sorted({i for box in boxes.values() for i in RR.box_tiles(box, tile, grid)})
    dec = RR.decode_tiles(run.state["blob"], ids, run.device, x=x)
    gap = 0.0
    for i, out in run.state["kept"].items():
        got = torch.from_numpy(np.require(out, requirements="W"))
        if tuple(got.shape) == tuple(shape):
            got = got[_slices(boxes[i])]
        want = RR.crop(dec, boxes[i])
        gap = max(gap, L.max_abs(got.to(run.device), want) / eb
                  if got.shape == want.shape else float("inf"))
    return [("gap_eb", gap, run.cfg["limits"]["gap_eb"]), ("codes_bad", dec.codes_bad, 0),
            ("crc_bad", dec.crc_bad, 0)]
