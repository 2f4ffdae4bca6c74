"""GWLZ-compressed checkpoint tensors (the paper's technique applied to the
framework's own state), port of ``repro/checkpoint/gwlz_ckpt.py``.

A weight tensor is compressed under an error bound by the SZ substrate;
one large enough to amortize a few enhancers gets the full GWLZ treatment
(grouped residual enhancers with a short training budget, clamped to the
SZ decode +- eb, so within 2 eb of the input).  The blob is the
reference's ``GWCK`` header (dtype name, original shape) followed by an
``SZJX`` container, and each package decodes the other's.

One difference from the reference, on purpose: a leaf of rank below 3
(an embedding, a projection) takes the SZ branch whatever its size.  The
reference hands such a leaf at or above ``enhance_threshold`` to the
enhancer trainer, which raises (``axis 3 is out of bounds``).  The
enhancers learn from 2-D slices of a 3-D volume; folding the leaf to
(1, H, W) gave the SZ stage one interp level and a 3-plane grid, and a
4096 x 4096 leaf landed at 95% of its raw bytes after ~16 s of training,
where the SZ branch alone gave 41% in 1.9 s (H100).  The reference
decodes the SZ branch's blob.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from repro_torch.checkpoint.manager import dtype_name
from repro_torch.core.pipeline import GWLZ
from repro_torch.core.trainer import GWLZTrainConfig
from repro_torch.errors import CorruptContainerError
from repro_torch.kernels.ops import resolve_device
from repro_torch.sz.szjax import SZCompressed, SZCompressor

_MAGIC = b"GWCK"


def _as_volume(v: torch.Tensor) -> torch.Tensor:
    """SZ works on 1-3-D grids: ranks above 3 fold into 3-D (lead, H, W)."""
    if v.ndim > 3:
        return v.reshape(-1, v.shape[-2], v.shape[-1])
    return v


def compress_tensor(v, *, rel_eb: float = 1e-4, enhance_threshold: int = 1 << 22,
                    epochs: int = 30, n_groups: int = 8, device=None) -> bytes:
    """Error-bounded blob of ``v`` (a tensor or numpy array; float32 or
    bfloat16 in checkpoints): SZ interp (``zlib`` backend) below
    ``enhance_threshold`` elements and for ranks below 3, GWLZ
    (``n_groups`` enhancers trained ``epochs`` epochs, batch 8) for a leaf
    of rank 3 or more at or above it.  Runs on ``device`` (None: the CUDA
    device, which must exist).

    The bound, with ``eb = rel_eb * (max - min)``: the SZ decode holds
    ``|x - x'| <= eb`` up to float32 rounding (a fraction of an ulp of
    max|x|, from the coarse grid's ``2eb * q``).  The GWLZ branch clamps the
    enhanced value to ``x' +- eb``, so where the gate keeps a group a point
    may land up to ``2 eb`` from the input (plus one more rounding); where
    it keeps none the decode is the SZ decode.  The reference behaves the
    same."""
    device = resolve_device(device)
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
    orig_dtype = dtype_name(t.dtype)
    shape = tuple(t.shape)
    use_gwlz = t.numel() >= enhance_threshold and t.ndim >= 3
    vol = _as_volume(t.detach().to(device=device, dtype=torch.float32))
    if use_gwlz:
        cfg = GWLZTrainConfig(n_groups=n_groups, epochs=epochs, batch_size=8)
        artifact, _stats = GWLZ(train_cfg=cfg, clamp_to_bound=True).compress(
            vol, rel_eb=rel_eb, device=device)
    else:
        artifact, _ = SZCompressor(predictor="interp", order="cubic", backend="zlib").compress(
            vol, rel_eb=rel_eb, device=device)
    dt = orig_dtype.encode()
    head = _MAGIC + struct.pack("<BB", len(shape), len(dt)) + dt
    head += struct.pack(f"<{len(shape)}q", *shape)
    return head + artifact.to_bytes()


def decompress_tensor(blob: bytes, *, device=None) -> torch.Tensor:
    """The tensor a :func:`compress_tensor` blob (either package's) holds,
    in its original shape and dtype, on ``device`` (None: the CUDA device,
    which must exist)."""
    device = resolve_device(device)
    if bytes(blob[:4]) != _MAGIC:
        raise CorruptContainerError("bad GWCK magic", offset=0, expected=_MAGIC,
                                    actual=bytes(blob[:4]))
    try:
        ndim, dlen = struct.unpack_from("<BB", blob, 4)
        off = 6
        dtype = bytes(blob[off : off + dlen]).decode()
        off += dlen
        shape = struct.unpack_from(f"<{ndim}q", blob, off)
    except struct.error as e:
        raise CorruptContainerError(f"truncated GWCK header: {e}", offset=4) from e
    off += 8 * ndim
    artifact = SZCompressed.from_bytes(blob[off:])
    with torch.no_grad():
        if "gwlz" in artifact.extras:
            out = GWLZ(clamp_to_bound=True).decompress(artifact, device=device)
        else:
            out = SZCompressor().decompress(artifact, device=device)
    return out.reshape(shape).to(getattr(torch, dtype))
