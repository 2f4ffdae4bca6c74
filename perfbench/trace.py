"""The device timeline of a bounded part of a run, from ``torch.profiler``,
reduced to what the per-layer readers take: kernel time by name, busy
time, the longest idle gaps and what the host was doing in them.

The profiler method is the one ``profile_port.py`` uses (CPU and CUDA
activity, device-side events only for device time); busy time is the union
of the device intervals, so nothing counts twice.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

_SKIP_HOST = ("ProfilerStep", "[memory]")
_NAME = 160  # characters of a (templated) kernel name kept in the breakdown


@dataclass
class DeviceTrace:
    ops: list = field(default_factory=list)  # (name, start_us, end_us) on the device
    host: list = field(default_factory=list)  # (name, start_us, end_us) host ops
    t0_us: float = 0.0
    t1_us: float = 0.0

    @property
    def window_s(self) -> float:
        return max(self.t1_us - self.t0_us, 0.0) / 1e6

    def _merged(self):
        out = []
        for _n, a, b in sorted(self.ops, key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._merged()) / 1e6

    def kernel_s(self, needle: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds ``needle``."""
        hits = [(b - a) for n, a, b in self.ops if needle in n]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, k: int = 10) -> list:
        by: dict[str, float] = {}
        for n, a, b in self.ops:
            by[n] = by.get(n, 0.0) + (b - a) / 1e6
        return [[n[:_NAME], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest stretches with nothing on the device, each named
        by the innermost host op running at its middle."""
        merged = self._merged()
        edges = [self.t0_us] + [v for ab in merged for v in ab] + [self.t1_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) / 2
            inner = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            name = min(inner)[1] if inner else "host: no torch op (Python)"
            out.append([name[:_NAME], (b - a) / 1e6])
        return out


class device_profile:
    """``with device_profile(device) as tr:`` records the device timeline of
    the block (which has to end with the work done: synchronise inside) and
    the host's torch ops beside it.  The events are read from the
    profiler's raw results, without building its per-event Python objects,
    which a GWLZ compress (millions of events) would make slow."""

    def __init__(self, device: str = "cuda"):
        self.trace = DeviceTrace()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def __enter__(self) -> DeviceTrace:
        self._prof.__enter__()
        return self.trace

    def __exit__(self, *exc) -> None:
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        tr = self.trace
        lo, hi = float("inf"), float("-inf")
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            a, b = e.start_ns() / 1e3, e.end_ns() / 1e3
            if e.device_type() == cuda:
                tr.ops.append((name, a, b))
            elif not name.startswith(_SKIP_HOST):
                tr.host.append((name, a, b))
            else:
                continue
            lo, hi = min(lo, a), max(hi, b)
        tr.t0_us, tr.t1_us = (lo, hi) if tr.ops or tr.host else (0.0, 0.0)
