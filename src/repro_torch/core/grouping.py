"""Value-based group partitioning (paper §3.3), port of
``repro/core/grouping.py``.

Strategies: ``"quantile"`` (equal-mass bins, the default), ``"range"``
(equal width over [min, max]) and ``"log"`` (log-spaced).  Edges are
computed on the *decompressed* data, so the decoder reproduces them.

``quantile`` edges equal the reference's ``jnp.quantile`` (XLA on the CPU)
bit for bit: the probabilities are ``arange(G+1) * float32(1/G)`` (what
XLA makes of ``jnp.linspace(0, 1, G+1)``), the values are sorted on the
tensor's device, and the linear interpolation is evaluated as XLA's CPU
code does, ``fma(high, w_high, round(low * w_low))``, with the FMA done as
one float64 sum rounded once to float32.  The indices are clamped to
``numel - 1``: at 2^27 values ``n - 1`` rounds up to 2^27 in float32, where
XLA's gather clamps and torch indexing would raise.  ``range`` and ``log``
follow the same reading of ``jnp.linspace``; they agree with the reference
to within 2 ulp (``tests/test_torch_grouping.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

STRATEGIES = ("quantile", "range", "log")


def _unit_steps(n_groups: int, device) -> torch.Tensor:
    """float32 ``arange(G) * float32(1/G)``: XLA's ``linspace(0, 1, G+1)``
    without its last point."""
    return (torch.arange(n_groups, dtype=torch.float32, device=device)
            * torch.tensor(np.float32(1.0 / n_groups), device=device))


def _linspace(lo: torch.Tensor, hi: torch.Tensor, n_groups: int) -> torch.Tensor:
    """float32 ``jnp.linspace(lo, hi, G+1)`` as XLA's CPU code evaluates it:
    lo (1 - s) + i (hi r), with r = 1/G, s = i r and the last add fused."""
    i = torch.arange(n_groups, dtype=torch.float32, device=lo.device)
    r = torch.tensor(np.float32(1.0 / n_groups), device=lo.device)
    a = lo * (1.0 - i * r)
    out = (i.double() * (hi * r).double() + a.double()).float()
    return torch.cat([out, hi.reshape(1)])


def _quantiles(flat: torch.Tensor, n_groups: int) -> torch.Tensor:
    srt = torch.sort(flat).values
    n = srt.numel()
    q = torch.cat([_unit_steps(n_groups, flat.device),
                   torch.ones(1, dtype=torch.float32, device=flat.device)])
    q = q * (torch.tensor(float(n), dtype=torch.float32, device=flat.device) - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    w_high = q - low
    w_low = 1.0 - w_high
    low_i = low.to(torch.int64).clamp_(0, n - 1)
    high_i = high.to(torch.int64).clamp_(0, n - 1)
    lv, hv = srt[low_i], srt[high_i]
    return (hv.double() * w_high.double() + (lv * w_low).double()).float()


def compute_edges(x: torch.Tensor, n_groups: int, strategy: str = "quantile") -> torch.Tensor:
    """Monotone bin edges, float32 [n_groups + 1] on ``x``'s device; values
    outside [edges[0], edges[-1]] fall into the end bins."""
    flat = torch.as_tensor(x).reshape(-1).to(torch.float32)
    if strategy == "quantile":
        # Coarsely quantized data gives duplicate quantiles (mass ties at grid
        # values), which would become degenerate near-empty bins.  Merge them
        # in float64 as the reference does; the removed bins are re-padded
        # past the max (empty, hence inactive through min_group_pixels).
        e = _quantiles(flat, n_groups).cpu().numpy().astype(np.float64)
        rng_ = max(e[-1] - e[0], 1e-30)
        keep = [e[0]]
        for v in e[1:]:
            if v - keep[-1] > rng_ * 1e-6:
                keep.append(v)
        pad = rng_ * 1e-3
        while len(keep) < n_groups + 1:
            keep.append(keep[-1] + pad)
        return torch.tensor(np.asarray(keep, np.float32), device=flat.device)
    lo, hi = flat.min(), flat.max()
    if strategy == "range":
        return _linspace(lo, hi, n_groups)
    if strategy == "log":
        shift = torch.where(lo <= 0, -lo + 1e-6 * (hi - lo) + 1e-30, 0.0)
        le = _linspace(torch.log(lo + shift), torch.log(hi + shift), n_groups)
        return torch.exp(le) - shift
    raise ValueError(f"unknown grouping strategy {strategy!r}")


def assign_groups(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """int32 group id per element, in [0, n_groups): the ``group_hist``
    kernel's ids (equal to the reference's searchsorted for finite x)."""
    return ops.group_hist_op(x, edges)[0]


def group_masks(ids: torch.Tensor, n_groups: int) -> torch.Tensor:
    """bool [n_groups, *ids.shape] one-hot masks."""
    return ids.unsqueeze(0) == torch.arange(n_groups, device=ids.device).view(
        (-1,) + (1,) * ids.ndim)


def group_normalizers(edges: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo[g], scale[g]) for min-max normalisation of group inputs; widths
    are guarded against zero."""
    lo, hi = edges[:-1], edges[1:]
    return lo, torch.clamp(hi - lo, min=1e-12)


def group_stats(x: torch.Tensor, ids: torch.Tensor, n_groups: int) -> dict:
    """Per-group count/mean/min/max (float32), as the reference's."""
    flat = torch.as_tensor(x).reshape(-1).to(torch.float32)
    gid = ids.reshape(-1).to(torch.int64)
    z = torch.zeros(n_groups, dtype=torch.float32, device=flat.device)
    counts = z.index_add(0, gid, torch.ones_like(flat))
    sums = z.index_add(0, gid, flat)
    mins = torch.full_like(z, float("inf")).scatter_reduce(0, gid, flat, "amin")
    maxs = torch.full_like(z, float("-inf")).scatter_reduce(0, gid, flat, "amax")
    return {"count": counts, "mean": sums / torch.clamp(counts, min=1.0),
            "min": mins, "max": maxs}
