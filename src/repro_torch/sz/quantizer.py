"""Prequantization onto the 2*eb grid (port of ``repro/sz/quantizer.py:27-59``).

Every value is snapped to ``q = rint(x / 2eb)``; the Lorenzo transform after
it is lossless integer arithmetic, so ``|x - 2eb*q| <= eb`` is the whole
error budget.  Bit parity with the reference rests on three facts:

* ``2eb`` is the float32 value of ``eb`` doubled (exact in float32),
* the division is IEEE round-to-nearest (the divisor is a 0-dim tensor on
  the data's device, see ``kernels.ref.two_eb_tensor``),
* ``torch.round`` rounds half to even, like ``jnp.rint``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ref import two_eb_tensor


def resolve_eb(x: torch.Tensor, rel_eb: float | None, abs_eb: float | None) -> float:
    """Absolute error bound from exactly one of rel_eb / abs_eb.

    The value range is a float32 subtraction, as in the reference; the
    guard rejects bounds so tight that the grid index leaves int32's exact
    float32 range."""
    if (rel_eb is None) == (abs_eb is None):
        raise ValueError("pass exactly one of rel_eb / abs_eb")
    if x.numel() == 0:
        raise ValueError("cannot resolve an error bound for an empty volume")
    mn, mx = torch.aminmax(x)
    vrange, amax = torch.stack([mx - mn, torch.maximum(mx.abs(), mn.abs())]).tolist()
    if rel_eb is not None:
        abs_eb = rel_eb * max(vrange, float(np.finfo(np.float32).tiny))
    abs_eb = float(abs_eb)
    max_q = amax / (2.0 * abs_eb)
    if max_q >= 2**30:
        raise ValueError(
            f"eb={abs_eb:g} too small for data magnitude (q={max_q:.3g} >= 2^30)")
    return abs_eb


def prequantize(x: torch.Tensor, eb: float) -> torch.Tensor:
    """int32 grid indices ``q`` with ``|x - 2*eb*q| <= eb``."""
    return torch.round(torch.div(x, two_eb_tensor(eb, x.device))).to(torch.int32)


def dequantize_pre(q: torch.Tensor, eb: float) -> torch.Tensor:
    """Inverse of :func:`prequantize`: float32(q) * 2eb."""
    return q.to(torch.float32) * two_eb_tensor(eb, q.device)
