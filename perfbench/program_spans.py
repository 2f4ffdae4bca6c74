"""Spans the program records itself (``repro_torch.obs``), for the readers
of ``source: program_span`` metrics.

A reader that reads them calls :func:`record` when the harness loads it,
which happens after set-up and before the window, and only in a traced
run: a run with ``--trace 0`` keeps the program's recorder off.  After the
window, :func:`per_op` gives each span to the window op whose ``[t0, t1]``
holds it (the program's spans and the loop's op stamps read the same
``perf_counter`` clock), leaving op 0 out: the profiler slows it, as
``measures._plain_ops`` says.  A program without the recorder records
nothing, and the readers then return None.
"""
from __future__ import annotations

import bisect
import importlib
import re

import numpy as np


# CUDA API calls that queue work on the device: kernel launches
# (cudaLaunchKernel, cudaLaunchKernelExC, cuLaunchKernel), copies and memsets
_QUEUE_CALL = re.compile(r"^cu(da)?(Launch|Memcpy|Memset)")


def _obs():
    try:
        return importlib.import_module("repro_torch.obs")
    except ImportError:  # a program without the recorder
        return None


def record() -> None:
    """Turn the program's recorder on (a no-op where it has none)."""
    obs = _obs()
    if obs is not None:
        obs.enable()


def per_op(run) -> list[list]:
    """The spans of each window op after op 0, in op order; taken from the
    program once a run (the recorder is then turned off)."""
    got = run.state.get("program_spans")
    if got is None:
        obs = _obs()
        recs = []
        if obs is not None and obs.enabled():
            recs = obs.take()
            obs.disable()
        got = run.state["program_spans"] = assign(recs, run.records)
    return got


def assign(recs, records) -> list[list]:
    """Each span of ``recs`` (``obs.Record``) to the op of ``records`` (the
    loop's dicts, ``t0``/``t1`` in seconds) whose interval holds it; one list
    per op with ``i >= 1``."""
    ops = sorted((r for r in records if r.get("i", 0) >= 1), key=lambda r: r["t0"])
    starts = [r["t0"] for r in ops]
    out: list[list] = [[] for _ in ops]
    for s in recs:
        t0, t1 = s.t0_ns / 1e9, s.t1_ns / 1e9
        k = bisect.bisect_right(starts, t0) - 1
        if k >= 0 and t1 <= ops[k]["t1"]:
            out[k].append(s)
    return out


def seconds(run, name: str) -> float | None:
    """Mean seconds an op spent in spans ``name`` (their durations summed;
    spans of one name do not nest), over the ops after op 0; None where no
    such op recorded one."""
    ops = per_op(run)
    if not any(s.name == name for spans in ops for s in spans):
        return None
    return float(np.mean([sum(s.seconds for s in spans if s.name == name) for spans in ops]))


def share_pct(run, name: str, attr: str) -> float | None:
    """Mean share (%) of an op's spans ``name`` whose attribute ``attr`` is
    set, over the ops after op 0 that recorded such spans."""
    got = []
    for spans in per_op(run):
        mine = [s for s in spans if s.name == name]
        if mine:
            got.append(100.0 * sum(bool(s.attrs.get(attr)) for s in mine) / len(mine))
    return float(np.mean(got)) if got else None


def launches_per_span(run, name: str) -> float | None:
    """CUDA launch and copy calls in the profiled op's trace that fall
    inside the program's spans ``name`` (its host events, on the profiler's
    clock), over the number of those spans; None where the trace holds no
    such span."""
    tr = run.dev_trace
    spans = sorted((a, b) for n, a, b in tr.host if n == name) if tr is not None else []
    if not spans:
        return None
    starts = [a for a, _b in spans]
    calls = 0
    for n, a, _b in tr.host:
        if _QUEUE_CALL.match(n):
            k = bisect.bisect_right(starts, a) - 1
            calls += k >= 0 and a <= spans[k][1]
    return calls / len(spans)
