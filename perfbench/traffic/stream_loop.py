"""Closed-loop out-of-core writer: one client streams field after field from
host memory (a pageable numpy array) into a journaled GWTC file with the
configuration's ``api.compress_stream`` call.  The inputs are a pool of
``fields`` distinct fields (seeds ``pool_seed``, ``pool_seed + 1``, ...;
made on the device once at set-up and kept in host memory), the same for
every run; the run's seed draws the order in which a cycle visits them,
and the window holds whole cycles.  After each op the finished file's bytes
are read back for the check and the file is deleted (a few tens of ms of
the op's time, beside seconds of streaming).

With enhancers, every op trains them on the executor's reservoir; probes
keep the reservoir (``streaming.ReservoirProbe``) and the first steps of
the training (``spans.TrainProbe``) for the check.

Mix parameters: ``fields``, ``pool_seed``, ``check_ops`` (ops of the
window, drawn from the seed, that the reference decodes).
"""
from __future__ import annotations

import gc
import math
import os

import numpy as np
import torch

from perfbench import loop as L
from perfbench import reference as R
from perfbench import streaming as S
from perfbench.reference import predictors as P
from perfbench.reference import reservoir as RS
from perfbench.reference import trainer as T
from perfbench.spans import TrainProbe


def _stream(run, j: int, name: str) -> tuple[dict, bytes]:
    path = os.path.join(S.io_dir(run), name)
    rec, blob = S.stream_file(run, run.state["fields"][j], path)
    os.unlink(path)
    return rec, blob


def setup(run) -> None:
    n = run.mix["fields"]
    fields = []
    for k in range(n):
        x = L.field(run, run.mix["pool_seed"] + k)
        fields.append(x.cpu().numpy())
        del x
    run.state["fields"] = fields
    run.state["order"] = np.random.default_rng([run.seed, 3]).permutation(n).tolist()
    if run.cfg.get("enhance"):
        run.state["probe"] = TrainProbe(run.cfg["adam"]["b1"]).install()
        run.state["reservoir_probe"] = S.ReservoirProbe().install()
    _stream(run, 0, "warmup.gwtc")  # warm-up at the window's shapes
    _take_probes(run)


def _take_probes(run) -> dict:
    if "probe" not in run.state:
        return {}
    got = {"train": run.state["probe"].take(), "reservoir": run.state["reservoir_probe"].take()}
    run.state["probe"].trainings.clear()
    return got


def window(run) -> None:
    fields, order = run.state["fields"], run.state["order"]
    blobs = run.state["blobs"] = []

    def op(i):
        j = order[i % len(fields)]
        rec, blob = _stream(run, j, f"op{i}.gwtc")
        blobs.append(blob)
        rec.update(field=j, **_take_probes(run))
        return rec

    L.closed_loop(run, op, cycle=len(fields))
    # the ops the reference checks; ``kept[j]`` is the field op j's file
    # decodes to: None, the reference's own float32 decode, unless a
    # control (perfbench/control.py) put its stand-in there
    checked = L.sample(run, len(run.records), run.mix["check_ops"], salt=1)
    run.state["kept"] = dict.fromkeys(checked)
    run.state["blob"] = blobs[checked[0]]
    for j, rec in enumerate(run.records):
        if j not in run.state["kept"]:
            rec.pop("reservoir", None)


def release(run) -> None:
    for key in ("probe", "reservoir_probe"):
        if key in run.state:
            run.state.pop(key).remove()
    S.remove_io_dir(run)
    gc.collect()
    if run.device != "cpu":
        torch.cuda.empty_cache()


def check(run) -> list:
    """The reference decodes the files of the checked ops, read back from
    disk: every value within the guarantee of its input, every code the one
    the input derives, every lane's CRC; no op may leave its commit
    journal.  With enhancers: the program's reservoir has to hold the tiles
    the reference's own Algorithm R draws from the configuration's seed
    over the stream's tile order, with the reference's decode of those
    tiles and their residuals (``reservoir_bad``: slots that differ by more
    than one float32 ulp of max|x|); the program's first training steps are
    held against the reference's on that reservoir (``reference.trainer.
    gaps``); and the reference applies the attached enhancers to the whole
    field, whose squared error has to fall by at least the limit's share."""
    cfg, fields, blobs = run.cfg, run.state["fields"], run.state["blobs"]
    err, lim, codes, crc = 0.0, float("inf"), 0, 0
    journal = sum(r["journal_left"] for r in run.records)
    res_bad, gain = 0, float("inf")
    train = dict.fromkeys(T.NUMBERS, 0.0)
    for j, stand_in in run.state["kept"].items():
        rec = run.records[j]
        x = torch.from_numpy(fields[rec["field"]]).to(run.device)
        eb = R.rel_eb_abs(x, cfg["rel_eb"])
        amax = float(x.abs().max())
        d = R.decode(blobs[j], run.device, x=x)
        got = d.sz if stand_in is None else torch.from_numpy(
            np.require(stand_in, requirements="W")).to(run.device)
        err = max(err, L.max_abs(got, x) / eb)
        lim = min(lim, L.err_limit(cfg, eb, amax))
        codes += d.codes_bad
        crc += d.crc_bad
        del got
        if cfg.get("enhance"):
            bad, sz_t, x_t = _reservoir(run, rec.get("reservoir"), d.sz, x, amax)
            res_bad += bad
            ref = T.first_steps(sz_t, x_t, cfg["enhance"], cfg["adam"])
            prog = rec.get("train")
            got = T.gaps(prog, ref) if prog else dict.fromkeys(T.NUMBERS, float("nan"))
            for k, v in got.items():
                train[k] = v if math.isnan(v) or v > train[k] else train[k]
            gain = min(gain, 100 * (1 - L.mse(d.out, x) / L.mse(d.sz, x)))
            del sz_t, x_t
        del d, x
    checks = [("err_eb", err, lim), ("codes_bad", codes, 0), ("crc_bad", crc, 0),
              ("journal_left", journal, 0)]
    if cfg.get("enhance"):
        lims = cfg["limits"]
        checks += [("reservoir_bad", res_bad, 0)]
        checks += [(k, v, lims[k]) for k, v in train.items()]
        checks += [("enh_gain_pct", gain, lims["enh_gain_pct"], ">=")]
    return checks


def _reservoir(run, reservoir, sz: torch.Tensor, x: torch.Tensor, amax: float):
    """(slots of the program's reservoir that differ from the reference's
    draw, the reference's SZ tiles and input tiles of that draw)."""
    cfg = run.cfg
    tile = cfg["tile"]
    n_tiles = math.prod(-(-d // t) for d, t in zip(x.shape, tile))
    ids = RS.draw(n_tiles, RS.default_capacity(cfg["mem_budget"], tile), cfg["enhance"]["seed"])
    sel = torch.tensor(ids, device=x.device)
    sz_t = P.split_tiles(sz, tile)[sel]
    x_t = P.split_tiles(x.to(torch.float32), tile)[sel]
    if reservoir is None:
        return len(ids), sz_t, x_t
    recon, resid = (torch.from_numpy(a).to(x.device) for a in reservoir.stacks())
    if recon.shape != sz_t.shape or resid.shape != sz_t.shape:
        return len(ids), sz_t, x_t
    tol = 2.0 ** -23 * amax
    off = torch.maximum((recon - sz_t).abs().amax(dim=(1, 2, 3)),
                        (resid - (x_t - sz_t)).abs().amax(dim=(1, 2, 3)))
    return int((off > tol).sum()), sz_t, x_t
