"""Closed-loop whole-field reader: set-up compresses the field of the run's
seed with the configuration's codec call; then one client opens the container's bytes on
a fresh handle (``api.from_bytes``) and decodes it whole to host memory
(``np.asarray``), op after op.  Every op decodes the same container: an
analyst re-reading a field.

Mix parameters: ``keep_share`` (the share of ops, drawn from the seed,
whose output the check holds against the reference, besides the first).
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from perfbench import loop as L
from perfbench import reference as R
from perfbench import work as W


def _read(run) -> np.ndarray:
    h = run.api.from_bytes(run.state["blob"], device=run.device)
    out = np.asarray(h)
    h.close()
    return out


def setup(run) -> None:
    x = L.field(run, run.seed)
    vol = run.api.compress(x, **run.compress_kwargs())
    run.state["blob"] = vol.to_bytes()
    vol.close()
    run.state["x"] = x.cpu()
    del x, vol
    gc.collect()
    _read(run)  # warm-up at the window's shapes


def window(run) -> None:
    rng = np.random.default_rng([run.seed, 2])
    kept = run.state["kept"] = {}
    nbytes = len(run.state["blob"])

    def op(i):
        out = _read(run)
        if i == 0 or rng.random() < run.mix["keep_share"]:
            kept[i] = out
        return {"raw": out.nbytes, "out": nbytes}

    L.closed_loop(run, op)


def release(run) -> None:
    gc.collect()
    if run.device != "cpu":
        torch.cuda.empty_cache()


def check(run) -> list:
    """The reference decodes the container; every kept output must equal
    it to the limit (``gap_eb``), the SZ values must hold the guarantee,
    the codes and CRCs must be the input's."""
    cfg = run.cfg
    x = run.state["x"].to(run.device)
    eb = R.rel_eb_abs(x, cfg["rel_eb"])
    d = R.decode(run.state["blob"], run.device, x=x)
    gap = max(L.max_abs(torch.from_numpy(np.require(out, requirements="W")).to(run.device), d.out)
              for out in run.state["kept"].values()) / eb
    checks = [("gap_eb", gap, cfg["limits"]["gap_eb"]),
              ("err_eb", L.max_abs(d.sz, x) / eb, L.err_limit(cfg, eb, float(x.abs().max()))),
              ("codes_bad", d.codes_bad, 0), ("crc_bad", d.crc_bad, 0)]
    if d.model is not None and run.trace:
        # the enhancer's work on this container, for its roofline reader
        sz_tiles = R.P.split_tiles(d.sz, cfg["tile"])
        xs = sz_tiles.reshape(-1, *sz_tiles.shape[2:])
        ids = R.E.group_ids(xs, torch.from_numpy(d.model["edges"]).to(run.device))
        live = [g for g in range(d.model["G"]) if float(d.model["rscale"][g]) > 0]
        flop = 0
        for i in range(0, xs.shape[0], 4096):
            flop += W.enhancer_flop(ids[i:i + 4096], live, d.model["C"])
        run.state["enh_flop"] = flop
        run.state["enh_values"] = xs.numel()
        run.state["enh_G_C"] = (d.model["G"], d.model["C"])
    return checks
