#!/usr/bin/env python3
"""How the JAX reference's interp floats depend on XLA:CPU's FMA contraction.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 interp_fma_probe.py

For a few fields, the reference (``repro``) compresses with the interp
predictor (cubic); its payload is then decoded three ways:

* by the reference itself (``repro.sz.predictor._interp_decode_padded``);
* in numpy with every float step a single float32 operation (the port's
  arithmetic, ``repro_torch/sz/predictor.py``);
* in numpy with fused multiply-adds where XLA may contract them: the
  cubic's two ``9 * e`` terms and the dequantization ``pred + code * 2eb``.

It prints, per field, how many decoded values differ from the reference's
in each form; for the single-op form (the port's), the largest difference
from the reference's decode and the largest error past eb, both in float32
ulps of max|x| (eps max|x|, eps = 2**-23), and how many of the codes a
single-op encoder writes differ from the reference's.  Then, for one
field, it tests the reference *encoder's* stored reconstruction level by
level: the share of coded targets whose value equals ``pred + code * 2eb``
unfused and fused (``pred`` from the encoder's own reconstruction, in both
of its forms).

An FMA is emulated in float64: the float32 product is exact there, and the
sum rounds twice (to 53 bits, then 24), which can differ from one
rounding only where the exact sum is within 2**-53 of a float32 midpoint.
CPU only; it reads and writes nothing on disk.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

FIELDS = [((48, 48, 48), "temperature", 1e-3), ((65, 65, 65), "velocity_x", 1e-4),
          ((64, 64, 64), "temperature", 1e-5), ((40, 33, 50), "baryon_density", 1e-3)]


def _f32(a):
    return np.asarray(a, np.float32)


def _fma(a, b, c):
    f64 = lambda v: np.asarray(_f32(v), np.float64)
    return _f32(f64(a) * f64(b) + f64(c))


def _pred(e: np.ndarray, axis: int, fused: bool) -> np.ndarray:
    n = e.shape[axis]
    take = lambda lo, m: np.take(e, np.arange(lo, lo + m), axis=axis)
    lin = _f32((take(0, n - 1) + take(1, n - 1)) * np.float32(0.5))
    if n < 4:
        return lin
    a, b, c, d = (take(i, n - 3) for i in range(4))
    nine = np.float32(9)
    if fused:
        t = _fma(nine, c, _fma(nine, b, -a))
    else:
        t = _f32(_f32(-a + _f32(b * nine)) + _f32(c * nine))
    cub = _f32(_f32(t - d) / np.float32(16))
    first = np.take(lin, [0], axis=axis)
    last = np.take(lin, [n - 2], axis=axis)
    return np.concatenate([first, cub, last], axis=axis)


def _sweeps(ndim: int, levels: int):
    for lv in range(levels, 0, -1):
        s = 1 << (lv - 1)
        known = [slice(0, None, 2 * s)] * ndim
        for axis in range(ndim):
            tgt, even = list(known), list(known)
            tgt[axis] = slice(s, None, 2 * s)
            yield s, axis, tuple(tgt), tuple(even)
            known[axis] = slice(0, None, s)


def numpy_decode(codes, omask, ovals, eb: float, levels: int, coarse_recon, fused: bool):
    """The reference's decode program in numpy, its float steps unfused or
    fused as ``fused`` says (the coarse grid is the reference's own)."""
    two_eb = np.float32(eb) * np.float32(2)
    recon = np.zeros(codes.shape, np.float32)
    S = 1 << levels
    recon[tuple(slice(0, None, S) for _ in codes.shape)] = coarse_recon
    for _s, axis, tgt, even in _sweeps(codes.ndim, levels):
        pred = _pred(recon[even], axis, fused)
        c = _f32(codes[tgt])
        rec = _fma(c, two_eb, pred) if fused else _f32(pred + _f32(c * two_eb))
        recon[tgt] = np.where(omask[tgt], ovals[tgt], rec)
    return recon


def numpy_encode(xp, eb: float, levels: int, coarse_codes, coarse_recon) -> np.ndarray:
    """The codes of the port's encoder (single float32 ops, half-to-even
    rounding, the outlier radius 2**15 and the float32 bound) in numpy; the
    coarse grid is the reference's own (integers, equal in both)."""
    two_eb, bound = np.float32(eb) * np.float32(2), np.float32(eb)
    codes = np.zeros(xp.shape, np.int32)
    recon = np.zeros(xp.shape, np.float32)
    coarse = tuple(slice(0, None, 1 << levels) for _ in xp.shape)
    codes[coarse], recon[coarse] = coarse_codes, coarse_recon
    for _s, axis, tgt, even in _sweeps(xp.ndim, levels):
        pred = _pred(recon[even], axis, False)
        sub = xp[tgt]
        code = np.rint(_f32(_f32(sub - pred) / two_eb))
        out = np.abs(code) >= 2**15
        code = np.where(out, 0, code).astype(np.int32)
        rec = _f32(pred + _f32(_f32(code) * two_eb))
        bad = np.abs(_f32(rec - sub)) > bound
        out |= bad
        codes[tgt] = np.where(bad, 0, code)
        recon[tgt] = np.where(out, sub, rec)
    return codes


def main() -> int:
    import jax.numpy as jnp

    from repro.data import nyx_like_field
    from repro.sz import predictor as RP
    from repro.sz.quantizer import resolve_eb

    for shape, field, rel_eb in FIELDS:
        x = jnp.asarray(nyx_like_field(shape, field, seed=0))
        eb = resolve_eb(x, rel_eb, None)
        codes, omask, ovals, _recon, meta = RP.interp_encode(x, eb, order="cubic")
        _, pshape, levels = meta
        want = np.asarray(RP._interp_decode_padded(codes, omask, ovals, eb, levels, "cubic"))
        coarse = want[tuple(slice(0, None, 1 << levels) for _ in pshape)]
        c, m, v = np.asarray(codes), np.asarray(omask), np.asarray(ovals)
        row = {"field": field, "shape": list(shape), "rel_eb": rel_eb, "values": want.size}
        unit = 2.0**-23 * float(jnp.max(jnp.abs(x)))
        crop = tuple(slice(0, d) for d in shape)
        for name, fused in (("single_ops_differ", False), ("fma_differ", True)):
            got = numpy_decode(c, m, v, eb, levels, coarse, fused)
            row[name] = int((got.view(np.uint32) != want.view(np.uint32)).sum())
            if not fused:
                diff = np.abs(got.astype(np.float64) - want)
                err = np.abs(got[crop].astype(np.float64) - np.asarray(x))
                row["single_ops_max_diff_ulps"] = float(diff.max()) / unit
                row["single_ops_err_past_eb_ulps"] = (float(err.max()) - eb) / unit
        xp = np.asarray(RP._pad_edge(x, pshape))
        sc = numpy_encode(xp, eb, levels, c[tuple(slice(0, None, 1 << levels) for _ in pshape)],
                          coarse)
        row["single_ops_codes_differ"] = int((sc != c).sum())
        print(json.dumps(row), flush=True)

    # the encoder's stored reconstruction, level by level (velocity_x 65^3)
    shape, field, rel_eb = FIELDS[1]
    x = jnp.asarray(nyx_like_field(shape, field, seed=0))
    eb = resolve_eb(x, rel_eb, None)
    levels = RP._num_levels(shape)
    xp = RP._pad_edge(x, RP._padded_shape(shape, levels))
    codes, omask, _ovals, recon = (np.asarray(a) for a in
                                   RP._interp_encode_padded(xp, eb, levels, "cubic"))
    two_eb = np.float32(eb) * np.float32(2)
    per_level: dict = {}
    for s, axis, tgt, even in _sweeps(len(shape), levels):
        keep = ~omask[tgt]
        c = _f32(codes[tgt])[keep]
        got = recon[tgt][keep].view(np.uint32)
        out = per_level.setdefault(s, {"targets": 0})
        out["targets"] += int(keep.sum())
        for pform in (False, True):
            p = _pred(recon[even], axis, pform)[keep]
            for rform, rec in (("unfused", _f32(p + _f32(c * two_eb))),
                               ("fused", _fma(c, two_eb, p))):
                key = f"pred_{'fma' if pform else 'single'}_rec_{rform}"
                out[key] = out.get(key, 0) + int((rec.view(np.uint32) == got).sum())
    print(json.dumps({"encoder": field, "shape": list(shape), "rel_eb": rel_eb,
                      "levels": {str(k): v for k, v in per_level.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
