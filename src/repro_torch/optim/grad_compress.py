"""Error-bounded gradient compression with error feedback, port of
``repro/optim/grad_compress.py`` (``:25-85``).

The paper's error-bounded uniform quantization applied to gradients:
each shard puts its gradient plus its error feedback on a grid of step
2 eb, with eb relative to the RMS, keeps what the rounding and the code
bound took off as its new error feedback, and reduces int8 / int16 codes
instead of float32 values.

:func:`compressed_psum` reduces the codes over a ``torch.distributed``
process group (an int32 ``all_reduce``); :func:`apply` with
``group=None`` quantizes in place, the reference's single-shard semantics
(``axis_name=None``).  The RMS is a reduction, so the scale may differ
from the reference's by an ulp, and a code whose value lies on a
half-integer of the grid may then round the other way.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch import tree


@dataclass(frozen=True)
class GradCompressConfig:
    rel_eb: float = 1e-2        # eb = rel_eb * rms(grad)
    code_dtype: str = "int8"    # int8 | int16
    enabled: bool = True


def _code_bound(dtype: str) -> int:
    return 127 if dtype == "int8" else 32767


def quantize_leaf(g: torch.Tensor, err: torch.Tensor, cfg: GradCompressConfig):
    """Returns (codes, scale, new_err): ``|codes * scale - (g + err)| <= eb``
    pointwise unless clipped at the code bound (the clipped mass goes into
    ``new_err``).  Codes round half to even, as ``jnp.rint``."""
    g_fb = g + err
    gf = g_fb.to(torch.float32)
    rms = torch.sqrt(torch.mean(gf * gf)) + 1e-20
    eb = cfg.rel_eb * rms
    scale = 2.0 * eb
    bound = _code_bound(cfg.code_dtype)
    codes = torch.clamp(torch.round(g_fb / scale), -bound, bound)
    new_err = (g_fb - codes * scale).to(err.dtype)
    dt = torch.int8 if cfg.code_dtype == "int8" else torch.int16
    return codes.to(dt), scale, new_err


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group, cfg: GradCompressConfig):
    """Quantize, sum the codes as int32 over ``group``, then dequantize with
    the group's mean scale and average: ``(sum codes) * mean_scale / n``.
    Returns (averaged gradient in ``g``'s dtype, new_err)."""
    codes, scale, new_err = quantize_leaf(g, err, cfg)
    summed = codes.to(torch.int32)
    dist.all_reduce(summed, group=group)
    scales = scale.reshape(1).clone()
    dist.all_reduce(scales, group=group)
    n = torch.full((), float(dist.get_world_size(group)), dtype=torch.float32,
                   device=g.device)
    mean_scale = scales[0] / n
    return (summed.to(torch.float32) * mean_scale / n).to(g.dtype), new_err


def init_ef(params) -> dict:
    """Zero error feedback, float32, one leaf per parameter."""
    return tree.rebuild(params, lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                                        device=p.device))


def apply(grads, ef_state, cfg: GradCompressConfig, group=None):
    """Quantize a whole gradient tree with error feedback.  With ``group``
    (a process group) the reduction itself runs on the int codes; without
    it this quantizes in place (single-shard semantics).  Returns (grads,
    ef_state), new trees of ``grads``' structure."""
    if not cfg.enabled:
        return grads, ef_state

    def one(path, g):
        e = tree.get(ef_state, path)
        if group is not None:
            return compressed_psum(g, e, group, cfg)
        codes, scale, ne = quantize_leaf(g, e, cfg)
        return (codes.to(torch.float32) * scale).to(g.dtype), ne

    out = tree.rebuild(grads, one)
    # the pairs sit where grads' leaves sat: take each side's tree
    new_g = tree.rebuild(grads, lambda path, _: tree.get(out, path)[0])
    new_e = tree.rebuild(grads, lambda path, _: tree.get(out, path)[1])
    return new_g, new_e
