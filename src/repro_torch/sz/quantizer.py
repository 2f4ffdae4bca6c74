"""Error-controlled quantization, port of ``repro/sz/quantizer.py``.

Two schemes, both holding ``|x - x'| <= eb`` pointwise:

1. *Prequantization* (the Lorenzo path): every value is snapped to
   ``q = rint(x / 2eb)``; the Lorenzo transform after it is lossless integer
   arithmetic, so ``|x - 2eb*q| <= eb`` is the whole error budget.
2. *Residual quantization* (the interp path): ``x - pred`` is quantized
   against a prediction from values already reconstructed; a code of
   magnitude ``OUTLIER_RADIUS`` or more, or a reconstruction that float32
   rounding puts past eb, makes the value an outlier stored verbatim.

Bit parity with the reference's prequantization rests on three facts:

* ``2eb`` is the float32 value of ``eb`` doubled (exact in float32),
* the division is IEEE round-to-nearest (the divisor is a 0-dim tensor on
  the data's device, see ``kernels.ref.two_eb_tensor``),
* ``torch.round`` rounds half to even, like ``jnp.rint``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ref import two_eb_tensor

# SZ-style quantization radius: codes live in (-R, R); |code| >= R means
# "unpredictable" -> store the exact value.
OUTLIER_RADIUS = 1 << 15


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


def quantize_residual(x: torch.Tensor, pred: torch.Tensor,
                      eb: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize ``x - pred`` with bound ``eb``.

    Returns ``(code, recon, is_outlier)``: int32 codes in (-R, R), 0 at
    outliers; the decoder-visible reconstruction ``pred + code * 2eb``,
    exactly ``x`` at outliers; the outlier mask.  Every step is one float32
    operation (no fused multiply-add), so the CPU and the card agree bit for
    bit; the bound is the float32 value of ``eb``."""
    two_eb = two_eb_tensor(eb, x.device)
    code = torch.round(torch.div(x - pred, two_eb))
    is_outlier = code.abs() >= OUTLIER_RADIUS
    code = code.masked_fill(is_outlier, 0.0).to(torch.int32)
    recon = pred + code.to(torch.float32) * two_eb
    # float32 rounding can put recon just past the bound: store those exactly
    bad = (recon - x).abs() > float(np.float32(eb))
    is_outlier |= bad
    code = code.masked_fill(bad, 0)
    recon = torch.where(is_outlier, x, recon)
    return code, recon, is_outlier
