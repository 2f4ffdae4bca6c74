"""The arithmetic behind the metric readers (``readers/<metric>.py``): each
reader names one of these.  A measure that finds nothing to read returns
None, and the harness leaves the metric out of the result line.
"""
from __future__ import annotations

import numpy as np

from perfbench import work as W
from perfbench.reference import container as C


def _plain_ops(run) -> list:
    """The window's ops that ran with no profiler on (in a traced run, op 0
    is profiled), or all of them where none did."""
    plain = [r for r in run.records if not run.trace or r.get("i", 0) >= 1]
    return plain or run.records


def rate_GBps(run) -> float | None:
    """Raw float32 bytes of every op that started in the window over the
    time from the window's start to the last op's end."""
    if not run.records:
        return None
    end = max(r["t1"] for r in run.records)
    return sum(r["raw"] for r in run.records) / (end - run.t_start) / 1e9


def ratio(run) -> float | None:
    """Raw bytes over container bytes, summed over the window's ops."""
    if not run.records:
        return None
    return sum(r["raw"] for r in run.records) / sum(r["out"] for r in run.records)


def setup_s(run) -> float:
    return run.setup_s


def train_s(run) -> float | None:
    """Mean training seconds a compress (``GWLZStats.seconds["train"]``)
    over the ops that ran with no profiler on."""
    got = [r["train_s"] for r in _plain_ops(run) if r.get("train_s") is not None]
    return float(np.mean(got)) if got else None


def span_s(run) -> float | None:
    """Mean seconds an op spent in the reader's spans, over the ops that
    ran them with no profiler on."""
    got = [sum(r["spans"].values()) for r in run.records
           if r.get("spans") and r.get("i", 0) >= 1]
    return float(np.mean(got)) if got else None


def device_idle_pct(run) -> float | None:
    tr = run.dev_trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def _lanes(blob: bytes):
    con = C.parse_gwtc(blob)
    lanes = []
    for lane in con.lanes:
        if con.predictor == "interp":
            n_out, zlen = np.frombuffer(lane, np.uint32, 2)
            lane = lane[8 + int(zlen):]
        lanes.append(C.parse_entropy(lane))
    return lanes


def _roofline_pct(kernel_s: float, nbytes: float, ops: float) -> float | None:
    if kernel_s <= 0:
        return None
    return 100.0 * W.least_s(nbytes, ops) / kernel_s


def huffman_encode_pct(run) -> float | None:
    """The encode kernel's launches in the profiled compress against the
    bound of packing every chunk of that compress's lanes."""
    if run.dev_trace is None:
        return None
    ks, n = run.dev_trace.kernel_s("huffman_encode_")
    if not n:
        return None
    lanes = [ln for ln in _lanes(run.state["blobs"][0]) if isinstance(ln, C.HuffmanLane)]
    nbytes = sum(W.huffman_encode_bytes(-(-ln.n // ln.chunk), ln.chunk,
                                        int(((ln.chunk_bits.astype(np.int64) + 31) // 32).sum()))
                 for ln in lanes)
    ops = sum(W.huffman_encode_ops(-(-ln.n // ln.chunk), ln.chunk) for ln in lanes)
    return _roofline_pct(ks, nbytes, ops)


def enhancer_fused_pct(run) -> float | None:
    """The group-wise enhancer's launches in the profiled decode against
    its bytes and the operations this container's group ids need."""
    if run.dev_trace is None or "enh_flop" not in run.state:
        return None
    ks, n = run.dev_trace.kernel_s("enhancer_grouped")
    if not n:
        return None
    G, Cc = run.state["enh_G_C"]
    return _roofline_pct(ks, W.enhancer_fused_bytes(run.state["enh_values"], G, Cc),
                         run.state["enh_flop"])


def step_mfu_write_pct(run) -> float | None:
    """The least time of every window op's counted work (the field read,
    the container written and, with an enhancer, the training and
    enhancement FLOPs) over the ops' measured time."""
    if not run.records:
        return None
    cfg = run.cfg
    enh = cfg.get("enhance")
    least = measured = 0.0
    for r in _plain_ops(run):
        n = r["raw"] // 4
        flop = W.gwlz_write_flop(n, enh["channels"], cfg["epochs"]) if enh else 0
        least += W.least_s(W.write_bytes(n, r["out"]), flop)
        measured += r["t1"] - r["t0"]
    return 100.0 * least / measured


def step_mfu_read_pct(run) -> float | None:
    """The least time of each whole-field decode (the container read, the
    values written and the enhancer's FLOPs on this container's groups)
    over the ops' measured time."""
    if not run.records:
        return None
    flop = run.state.get("enh_flop", 0)
    least = measured = 0.0
    for r in _plain_ops(run):
        least += W.least_s(W.read_bytes(r["raw"] // 4, r["out"]), flop)
        measured += r["t1"] - r["t0"]
    return 100.0 * least / measured
