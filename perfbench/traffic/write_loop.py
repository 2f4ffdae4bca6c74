"""Closed-loop writer: one client compresses field after field with the
configuration's codec call and serialises each container (``to_bytes``).
The inputs are a pool of ``fields`` distinct fields (seeds ``pool_seed``,
``pool_seed + 1``, ...; kept on the device), the same for every run; the
run's seed draws the order in which a cycle visits them, and the window
holds whole cycles, so every run does the same work.  Containers stay in
memory; nothing is written to disk.

With enhancers, every compress trains them from the configuration's
seed; a probe (``spans.TrainProbe``) keeps the first steps of each op's
training for the check.

Mix parameters: ``fields``, ``pool_seed``, ``check_ops`` (ops of the
window, drawn from the seed, that the reference decodes).
"""
from __future__ import annotations

import gc
import math

import numpy as np
import torch

from perfbench import loop as L
from perfbench import reference as R
from perfbench.reference import predictors as P
from perfbench.reference import trainer as T
from perfbench.spans import TrainProbe


def _compress(run, x):
    vol = run.api.compress(x, **run.compress_kwargs())
    blob = vol.to_bytes()
    st = vol.train_stats  # GWLZStats of an enhanced compress, else None
    vol.close()
    return blob, st


def setup(run) -> None:
    n = run.mix["fields"]
    run.state["fields"] = [L.field(run, run.mix["pool_seed"] + k) for k in range(n)]
    run.state["order"] = np.random.default_rng([run.seed, 3]).permutation(n).tolist()
    run.sync()
    if run.cfg.get("enhance"):
        run.state["probe"] = TrainProbe(run.cfg["adam"]["b1"]).install()
    _compress(run, run.state["fields"][0])  # warm-up at the window's shapes


def window(run) -> None:
    fields, order = run.state["fields"], run.state["order"]
    blobs = run.state["blobs"] = []

    def op(i):
        j = order[i % len(fields)]
        blob, st = _compress(run, fields[j])
        blobs.append(blob)
        rec = {"raw": 4 * fields[j].numel(), "out": len(blob), "field": j}
        if st is not None:
            rec.update(train_s=st.seconds["train"], psnr_gwlz=st.psnr_gwlz)
        if "probe" in run.state:
            rec["train"] = run.state["probe"].take()
            run.state["probe"].trainings.clear()
        return rec

    L.closed_loop(run, op, cycle=len(fields))


def release(run) -> None:
    if "probe" in run.state:
        run.state.pop("probe").remove()
    gc.collect()
    if run.device != "cpu":
        torch.cuda.empty_cache()


def check(run) -> list:
    """Decode sampled containers of the window with the reference: every
    value within the guarantee of its input, every code the one the input
    derives, every lane's CRC.  With enhancers, the reference trains its
    own from the field and the SZ field for the first steps, and holds the
    program's first steps of the op's training against them
    (``reference.trainer.gaps``); and it applies the attached enhancers to
    the SZ field: its squared error has to fall by at least the limit's
    share, and its PSNR has to be the one the program reported for the op."""
    cfg, fields, blobs = run.cfg, run.state["fields"], run.state["blobs"]
    err, lim, codes, crc = 0.0, float("inf"), 0, 0
    gain, gap = float("inf"), 0.0
    train = dict.fromkeys(T.NUMBERS, 0.0)
    for j in L.sample(run, len(run.records), run.mix["check_ops"], salt=1):
        x = fields[run.records[j]["field"]]
        eb = R.rel_eb_abs(x, cfg["rel_eb"])
        # float32, or the control's lower precision (perfbench/control.py)
        d = R.decode(blobs[j], run.device, x=x,
                     dtype=run.state.get("decode_dtype", torch.float32))
        err = max(err, L.max_abs(d.sz, x) / eb)
        lim = min(lim, L.err_limit(cfg, eb, float(x.abs().max())))
        codes += d.codes_bad
        crc += d.crc_bad
        if cfg.get("enhance"):
            sz = d.sz if d.exact else R.decode(blobs[j], run.device, enhance=False).sz
            for k, v in _train_gaps(run, run.records[j].get("train"), sz, x).items():
                train[k] = v if math.isnan(v) or v > train[k] else train[k]
            del sz
        if d.model is not None:
            m_enh = L.mse(d.out, x)
            gain = min(gain, 100 * (1 - m_enh / L.mse(d.sz, x)))
            vr = float(x.max()) - float(x.min())
            psnr = 20 * math.log10(vr) - 10 * math.log10(max(m_enh, 1e-30))
            gap = max(gap, abs(psnr - run.records[j]["psnr_gwlz"]))
        del d
    checks = [("err_eb", err, lim), ("codes_bad", codes, 0), ("crc_bad", crc, 0)]
    if cfg.get("enhance"):
        lims = cfg["limits"]
        checks += [(k, v, lims[k]) for k, v in train.items()]
        checks += [("enh_gain_pct", gain, lims["enh_gain_pct"], ">="),
                   ("psnr_gap_db", gap, lims["psnr_gap_db"])]
    return checks


def _train_gaps(run, prog, sz: torch.Tensor, x: torch.Tensor) -> dict:
    """The reference's first steps on this op's field against the program's
    (``prog``, the probe's record; NaN where the program trained no first
    steps).  The control puts the reference in a lower precision
    (``state["train_dtype"]``) in the program's place."""
    cfg = run.cfg
    tile = cfg["tile"]
    sz_t, x_t = P.split_tiles(sz, tile), P.split_tiles(x.to(torch.float32), tile)
    ref = T.first_steps(sz_t, x_t, cfg["enhance"], cfg["adam"])
    if "train_dtype" in run.state:
        prog = T.first_steps(sz_t, x_t, cfg["enhance"], cfg["adam"],
                             dtype=run.state["train_dtype"])
    return T.gaps(prog, ref) if prog else dict.fromkeys(T.NUMBERS, float("nan"))
