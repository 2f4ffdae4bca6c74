"""The out-of-core cells (``stream-write``, ``gwlz-region``) at a small size
on the CPU: the port's streamed file and box reads against the plain
reference (decode, reservoir draw, decode-enhance-crop), the cells'
traced result lines, and the controls their checks must catch."""
from __future__ import annotations

import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from perfbench import control_out_of_core as CO  # noqa: E402
from perfbench import harness as H  # noqa: E402
from perfbench import loop as L  # noqa: E402
from perfbench import program_spans  # noqa: E402
from perfbench import reference as R  # noqa: E402
from perfbench import streaming as S  # noqa: E402
from perfbench.reference import nyx  # noqa: E402
from perfbench.reference import predictors as P  # noqa: E402
from perfbench.reference import region as RR  # noqa: E402
from perfbench.reference import reservoir as RS  # noqa: E402

BENCH = H.load_json(ROOT / "BENCHMARK.json")
CFG = H.load_json(ROOT / "perfbench/configs/nyx512-gwlz-stream.json")
TILE = (32, 32, 32)
# four tiles a batch on the CPU (12 bytes a value of working set, two
# batches in flight): the 64 x 64 x 128 field's 16 tiles in four batches,
# and the default reservoir max(4, budget / 4 / 256 KiB) = 4 tiles
BUDGET = 4 * 2 * 12 * 32 ** 3


def fast(cell: str) -> dict:
    """The cell at 32^3 with 16^3 tiles under a 512 KiB budget (two batches,
    a reservoir of 4 of the 8 tiles), 3 groups and 1 epoch (which gain
    ~0.2-0.7% of the squared error at this size, so the gain's limit here
    is 0.1%), and boxes of sides 4-20."""
    return {"cfg": {"shape": [32, 32, 32], "tile": [16, 16, 16], "mem_budget": 1 << 19,
                    "epochs": 1,
                    "enhance": {**CFG["enhance"], "n_groups": 3},
                    "limits": {**CFG["limits"], "enh_gain_pct": 0.1}},
            "mix": {"side_min": 4, "side_max": 20} if cell == "gwlz-region" else {}}


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    """A Nyx-like 64 x 64 x 128 field streamed into a file in four batches
    with one epoch of the configuration's enhancers: (field, file, report,
    the reservoir the port trained on)."""
    from repro_torch import api
    from repro_torch.core.trainer import GWLZTrainConfig

    x = nyx.field((64, 64, 128), CFG["field"], 2**31 + 11, "cpu")
    path = str(tmp_path_factory.mktemp("stream") / "f.gwtc")
    probe = S.ReservoirProbe().install()
    try:
        rep = api.compress_stream(x.numpy(), path, eb=CFG["rel_eb"], tile=TILE,
                                  mem_budget=BUDGET, predictor="lorenzo",
                                  enhance=GWLZTrainConfig(**CFG["enhance"], epochs=1),
                                  device="cpu")
        reservoir = probe.take()
    finally:
        probe.remove()
    return x, path, rep, reservoir


def test_streamed_file_is_the_references_decode(streamed):
    x, path, rep, _res = streamed
    assert rep.n_batches >= 4 and rep.enhanced
    assert not os.path.exists(path + ".journal")
    d = R.decode(Path(path).read_bytes(), "cpu", x=x)
    eb = R.rel_eb_abs(x, CFG["rel_eb"])
    assert d.codes_bad == 0 and d.crc_bad == 0
    assert L.max_abs(d.sz, x) / eb <= L.err_limit(CFG, eb, float(x.abs().max()))


def test_reservoir_holds_the_references_draw(streamed):
    x, path, rep, reservoir = streamed
    n_tiles = rep.n_tiles
    cap = RS.default_capacity(BUDGET, TILE)
    ids = RS.draw(n_tiles, cap, CFG["enhance"]["seed"])
    assert rep.reservoir_tiles == cap == len(ids) == 4 and ids != list(range(cap))
    sz = R.decode(Path(path).read_bytes(), "cpu").sz
    recon, resid = (torch.from_numpy(a) for a in reservoir.stacks())
    sz_t, x_t = P.split_tiles(sz, TILE)[ids], P.split_tiles(x, TILE)[ids]
    assert torch.equal(recon, sz_t) and torch.equal(resid, x_t - sz_t)


@pytest.mark.parametrize("n,cap,seed", [(16, 4, 0), (512, 32, 0), (100, 7, 3), (5, 8, 1)])
def test_reference_draw_is_the_ports_reservoir(n, cap, seed):
    from repro_torch.core.trainer import TileReservoir

    res = TileReservoir(cap, seed=seed)
    ids = np.arange(n, dtype=np.float32)[:, None]
    for a in range(0, n, 3):  # batches of three tiles
        res.offer(ids[a:a + 3], ids[a:a + 3])
    got = res.stacks()[0][:, 0].astype(int).tolist()
    assert got == RS.draw(n, cap, seed)


def test_boxes_equal_the_references_crop(streamed):
    from repro_torch import api

    x, path, _rep, _res = streamed
    eb = R.rel_eb_abs(x, CFG["rel_eb"])
    boxes = [((0, 64), (0, 64), (0, 128)), ((5, 37), (31, 33), (60, 127)),
             ((40, 41), (0, 64), (96, 128))]
    blob = Path(path).read_bytes()
    grid = [-(-d // t) for d, t in zip(x.shape, TILE)]
    with api.open(path, cache_bytes=1 << 20, device="cpu") as vol:
        for box in boxes:
            dec = RR.decode_tiles(blob, RR.box_tiles(box, TILE, grid), "cpu", x=x)
            got = torch.from_numpy(vol[tuple(slice(a, b) for a, b in box)])
            assert dec.codes_bad == 0 and dec.crc_bad == 0
            assert L.max_abs(got, RR.crop(dec, box)) / eb <= CFG["limits"]["gap_eb"]
    whole = R.decode(blob, "cpu").out
    dec = RR.decode_tiles(blob, range(math.prod(grid)), "cpu")
    assert torch.equal(RR.crop(dec, boxes[1]), whole[5:37, 31:33, 60:127])


@pytest.mark.parametrize("cell", ["stream-write", "gwlz-region"])
def test_traced_run_reports_the_new_metrics(cell):
    run, kind = H.prepare(BENCH, cell, 2**31 + 5, 0.05, True, "cpu", fast(cell))
    out = H.execute(BENCH, run, kind, time.perf_counter())
    assert out["correct"], out["checks"]
    mine = {m["name"] for m in BENCH["per_layer"] if m.get("workloads") == [cell]}
    if cell == "gwlz-region":  # every tile a hit once the small field is cached
        mine -= {"region_enhance_s"}
    assert mine and mine <= set(out["metrics"]), out["metrics"]
    assert all(v["value"] >= 0 for v in out["metrics"].values())


@pytest.mark.parametrize("cell,control,caught", [
    ("stream-write", "bf16", "err_eb"), ("stream-write", "reservoir_seed", "reservoir_bad"),
    ("stream-write", "code", "codes_bad"), ("gwlz-region", "bf16", "gap_eb"),
    ("gwlz-region", "shift", "gap_eb")])
def test_control_comes_out_not_correct(cell, control, caught):
    got = CO.control_run(BENCH, cell, control, 17, 0.05, "cpu", fast(cell))
    assert not got["correct"], got["checks"]
    c = got["checks"][caught]
    assert c["value"] > c["limit"], got["checks"]


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]
                                  if m.get("workloads") in (["stream-write"], ["gwlz-region"])])
def test_new_readers_read_nothing_without_the_programs_spans(name):
    """A program without the spans (the parent of the change that added
    them) records none: each new reader returns None and raises nothing."""
    run = H.Run("stream-write", CFG, {}, 1, 1.0, True, "cpu")
    run.records = [{"t0": 0.0, "t1": 1.0, "i": 0}, {"t0": 1.0, "t1": 2.0, "i": 1}]
    run.state["program_spans"] = program_spans.assign([], run.records)
    reader = H._load(ROOT / "perfbench" / "readers" / f"{name}.py", "reader_under_test")
    assert reader.read(run) is None
