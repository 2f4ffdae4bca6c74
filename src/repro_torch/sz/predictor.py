"""Prediction transforms, port of ``repro/sz/predictor.py``: Lorenzo,
SZ3-style multi-level interpolation, and the tile-predictor registry.

*Lorenzo.*  Values are prequantized onto the 2*eb grid and an exact integer
Lorenzo stencil decorrelates them; reconstruction is an int32 cumsum along
each axis.  The whole-volume encode (the monolithic SZJX path) runs on the
``lorenzo_quant`` kernel, the per-tile one on ``lorenzo_quant_tiles``.

*Interpolation.*  The volume is edge-padded to ``M * 2**levels + 1`` a
dim; the coarse grid (stride ``S = 2**levels``) is Lorenzo-coded through
the same two kernels, then each level (stride S/2 ... 1) predicts, axis by
axis, the points at odd multiples of the stride from the reconstructed even
grid -- linear, or the 4-point cubic with linear borders -- and quantizes
the residual (``quantizer.quantize_residual``).  Every array carries a
leading batch axis, so one code path serves the whole volume (B = 1) and
the tiles of the tiled engine.

The port's interp arithmetic is fixed, and is not the reference's bit for
bit (the reference's float results follow XLA's fusion, which contracts
some multiply-adds into FMAs and not others, by sweep and by shape).  Every
float step is a single IEEE float32 operation in the reference's operation
order, with no fused multiply-add:

* linear: ``(e0 + e1) * 0.5``;
* cubic: ``((-e0 + e1 * 9) + e2 * 9 - e3) / 16``;
* dequantization: ``pred + code * 2eb``;
* residual: ``round((x - pred) / 2eb)``, half to even, the divisor a
  float32 tensor on the data's device (a true division on CUDA);
* outlier test: ``|recon - x| > float32(eb)``.

As plain torch ops (each its own kernel: nothing can contract; ``/ 16`` and
``* 0.5`` are exact) this gives the same bits on the CPU and on the card,
whatever the batch: the decode has no reductions and nothing depends on the
batch size, so a region decode equals the full decode's crop.  Straggler
promotion runs the port's own decoder, so the port's artifacts hold
``|x - x'| <= eb`` exactly on both devices.  The reference's artifacts
decode within a few float32 ulps of the reference's decode (the tests state
the tolerance).

The tiled engine dispatches its per-tile transform through
:func:`get_predictor`.  The wire ids are the reference's, so containers
name predictors identically.
"""
from __future__ import annotations

import math
import struct
import zlib

import numpy as np
import torch

from repro_torch import obs
from repro_torch.errors import CorruptContainerError
from repro_torch.kernels.ref import two_eb_tensor
from repro_torch.sz.quantizer import dequantize_pre, quantize_residual


def lorenzo_encode(x: torch.Tensor, eb: float) -> torch.Tensor:
    """x -> int32 Lorenzo deltas of the prequantized grid (lossy only in
    the prequantization), through ``ops.lorenzo_quant_op``: the
    ``lorenzo_quant`` kernel on the card (volumes of rank up to 3), the
    plain version on the CPU (any rank)."""
    from repro_torch.kernels import ops

    return ops.lorenzo_quant_op(x.to(torch.float32), eb)


def lorenzo_decode(codes: torch.Tensor, eb: float) -> torch.Tensor:
    """Exact inverse: int32 cumsum along each axis, then dequantize."""
    q = codes
    for ax in range(q.ndim):
        q = torch.cumsum(q, dim=ax, dtype=torch.int32)
    return dequantize_pre(q, eb)


# ---------------------------------------------------------------------------
# Multi-level interpolation (SZ3-style)
# ---------------------------------------------------------------------------


def _num_levels(shape: tuple[int, ...], max_levels: int = 5) -> int:
    m = min(shape)
    if m < 3:
        return 1
    return max(1, min(max_levels, int(math.floor(math.log2(m - 1)))))


def _padded_shape(shape: tuple[int, ...], levels: int) -> tuple[int, ...]:
    """Pad each dim to M * 2**levels + 1 so every interp neighbour exists."""
    s = 1 << levels
    return tuple(((max(d - 1, 1) + s - 1) // s) * s + 1 for d in shape)


def pad_edge(x: torch.Tensor, shape: tuple[int, ...], first_axis: int = 0) -> torch.Tensor:
    """Edge-mode padding of the axes from ``first_axis`` on up to ``shape``,
    as an index-clamp gather per axis (any rank)."""
    for ax, p in enumerate(shape, start=first_axis):
        d = x.shape[ax]
        if p != d:
            idx = torch.arange(p, device=x.device).clamp_(max=d - 1)
            x = x.index_select(ax, idx)
    return x


def _level_strides(levels: int) -> list[int]:
    return [1 << (lv - 1) for lv in range(levels, 0, -1)]  # S/2 ... 1 where S=2**levels


def _coarse(ndim: int, levels: int) -> tuple[slice, ...]:
    """The coarse grid (stride 2**levels) of a batch [B, *pshape]."""
    return (slice(None),) + (slice(0, None, 1 << levels),) * ndim


def _sweeps(ndim: int, levels: int):
    """Every interpolation sweep in order (levels S/2 ... 1, then axes):
    ``(axis, targets, even grid)``, the axis and slices over a batch
    [B, *pshape].  Targets sit at odd multiples of the stride ``s`` along
    ``axis``, their sources at even multiples, so writing the targets in
    place never touches a source."""
    for s in _level_strides(levels):
        known = [slice(0, None, 2 * s)] * ndim  # each dim is dense at stride 2s
        for axis in range(ndim):
            tgt, even = list(known), list(known)
            tgt[axis] = slice(s, None, 2 * s)
            yield axis + 1, (slice(None), *tgt), (slice(None), *even)
            known[axis] = slice(0, None, s)  # this axis is now dense at stride s


def _interp_pred(e: torch.Tensor, axis: int, order: str) -> torch.Tensor:
    """Predict the targets between the even-grid points ``e`` along
    ``axis`` (M + 1 points give M predictions)."""
    n = e.shape[axis]
    lin = (e.narrow(axis, 0, n - 1) + e.narrow(axis, 1, n - 1)) * 0.5
    if order == "linear" or n < 4:
        return lin
    # 4-point cubic (Lagrange) in the interior, linear at the two borders
    cub = ((-e.narrow(axis, 0, n - 3) + e.narrow(axis, 1, n - 3) * 9.0)
           + e.narrow(axis, 2, n - 3) * 9.0 - e.narrow(axis, 3, n - 3)) / 16.0
    return torch.cat([lin.narrow(axis, 0, 1), cub, lin.narrow(axis, n - 2, 1)], dim=axis)


def _coarse_codes(xc: torch.Tensor, eb: float) -> torch.Tensor:
    """Lorenzo codes of the coarse grids [B, *coarse]: the whole-volume
    kernel for one volume, the tiles kernel for a batch."""
    from repro_torch.kernels import ops

    xc = xc.contiguous()
    if xc.shape[0] == 1:
        return ops.lorenzo_quant_op(xc[0], eb)[None]
    return ops.lorenzo_quant_tiles_op(xc, eb)


def _interp_encode_padded(xp: torch.Tensor, eb: float, levels: int, order: str):
    """Encode a batch of edge-padded volumes [B, *pshape]; returns
    (codes, omask, ovals, recon), all [B, *pshape]."""
    from repro_torch.kernels import ops

    coarse = _coarse(xp.ndim - 1, levels)
    codes = torch.zeros(xp.shape, dtype=torch.int32, device=xp.device)
    omask = torch.zeros(xp.shape, dtype=torch.bool, device=xp.device)
    ovals = torch.zeros_like(xp)
    recon = torch.zeros_like(xp)
    cc = _coarse_codes(xp[coarse], eb)
    codes[coarse] = cc
    recon[coarse] = ops.lorenzo_decode_tiles_op(cc, eb)
    for axis, tgt, even in _sweeps(xp.ndim - 1, levels):
        pred = _interp_pred(recon[even], axis, order)
        sub = xp[tgt]
        code, rec, outl = quantize_residual(sub, pred, eb)
        codes[tgt] = code
        omask[tgt] = outl
        ovals[tgt] = torch.where(outl, sub, 0.0)
        recon[tgt] = rec
    return codes, omask, ovals, recon


def _interp_decode_padded(codes: torch.Tensor, omask: torch.Tensor, ovals: torch.Tensor,
                          eb: float, levels: int, order: str) -> torch.Tensor:
    """Decode a batch [B, *pshape]; elementwise in the batch axis."""
    from repro_torch.kernels import ops

    coarse = _coarse(codes.ndim - 1, levels)
    two_eb = two_eb_tensor(eb, codes.device)
    recon = torch.zeros(codes.shape, dtype=torch.float32, device=codes.device)
    recon[coarse] = ops.lorenzo_decode_tiles_op(codes[coarse], eb)
    for axis, tgt, even in _sweeps(codes.ndim - 1, levels):
        pred = _interp_pred(recon[even], axis, order)
        rec = pred + codes[tgt].to(torch.float32) * two_eb
        recon[tgt] = torch.where(omask[tgt], ovals[tgt], rec)
    return recon


def _promote_stragglers(xp, codes, omask, ovals, eb: float, levels: int, order: str):
    """Bound enforcement shared by the monolithic and tiled encoders.

    Re-derives the recon the *decoder* produces and promotes every point
    past the bound (outside the coarse grid, which is Lorenzo-coded and never
    consults the mask), pad cells included, to an exact-valued outlier,
    until none is left.  Each round strictly grows ``omask``, so the loop
    ends.  The port's decoder repeats its encoder's arithmetic, so it runs
    no round in practice; it is kept as the guarantee.  Returns (omask,
    ovals, recon, rounds) with ``recon`` the decoder's output."""
    bound = float(np.float32(eb))
    coarse = _coarse(xp.ndim - 1, levels)
    recon = _interp_decode_padded(codes, omask, ovals, eb, levels, order)
    rounds = 0
    while True:
        bad = ((recon - xp).abs() > bound) & ~omask
        bad[coarse] = False
        if not bool(bad.any()):
            return omask, ovals, recon, rounds
        omask = omask | bad
        ovals = torch.where(bad, xp, ovals)
        recon = _interp_decode_padded(codes, omask, ovals, eb, levels, order)
        rounds += 1


def interp_encode_batch(xp: torch.Tensor, eb: float, levels: int, order: str):
    """Encode a batch of edge-padded volumes [B, *pshape] and enforce the
    bound: returns (codes, omask, ovals, recon, straggler rounds), ``recon``
    being the decoder's own output."""
    codes, omask, ovals, _ = _interp_encode_padded(xp, eb, levels, order)
    omask, ovals, recon, rounds = _promote_stragglers(xp, codes, omask, ovals, eb, levels,
                                                      order)
    return codes, omask, ovals, recon, rounds


def interp_encode(x: torch.Tensor, eb: float, order: str = "cubic", max_levels: int = 5):
    """Multi-level interpolation encode of one volume.

    Returns ``(codes, omask, ovals, recon, meta)``: arrays on the padded
    grid, ``meta = (orig_shape, padded_shape, levels)``; ``recon`` is the
    decoder's output, and cropped to ``orig_shape`` it holds the bound."""
    shape = tuple(x.shape)
    levels = _num_levels(shape, max_levels)
    pshape = _padded_shape(shape, levels)
    xp = pad_edge(x.to(torch.float32), pshape)[None]
    codes, omask, ovals, recon, _ = interp_encode_batch(xp, eb, levels, order)
    return codes[0], omask[0], ovals[0], recon[0], (shape, pshape, levels)


def interp_decode(codes, omask, ovals, eb: float, meta, order: str = "cubic") -> torch.Tensor:
    orig_shape, _pshape, levels = meta
    recon = _interp_decode_padded(codes[None], omask[None], ovals[None], eb, levels, order)[0]
    return recon[tuple(slice(0, d) for d in orig_shape)].contiguous()


def scatter_outliers(idx: np.ndarray, val: np.ndarray, shape: tuple[int, ...],
                     device) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense (omask, ovals) of ``shape`` on ``device`` from flat outlier
    indices and values (read from a container: out-of-range indices
    raise)."""
    n = math.prod(shape)
    omask = torch.zeros(n, dtype=torch.bool, device=device)
    ovals = torch.zeros(n, dtype=torch.float32, device=device)
    if idx.size:
        if int(idx.min()) < 0 or int(idx.max()) >= n:
            raise CorruptContainerError("outlier index outside the padded volume",
                                        offset=0, expected=f"0..{n - 1}",
                                        actual=(int(idx.min()), int(idx.max())))
        i = torch.from_numpy(np.asarray(idx, np.int64).copy()).to(device)
        omask[i] = True
        ovals[i] = torch.from_numpy(np.array(val, np.float32)).to(device)
    return omask.view(shape), ovals.view(shape)


# Canonical wire ids shared by the SZJX and GWTC containers.
PRED_IDS = {"lorenzo": 0, "interp": 1}
PRED_NAMES = {v: k for k, v in PRED_IDS.items()}
ORDER_IDS = {"linear": 0, "cubic": 1}
ORDER_NAMES = {v: k for k, v in ORDER_IDS.items()}

PREDICTORS: dict[str, "TilePredictor"] = {}


def register_predictor(cls: type) -> type:
    PREDICTORS[cls.name] = cls()
    return cls


def get_predictor(name: str) -> "TilePredictor":
    try:
        return PREDICTORS[name]
    except KeyError:
        raise ValueError(
            f"unknown predictor {name!r} (registered: {sorted(PREDICTORS)})"
        ) from None


class TilePredictor:
    """Protocol for per-tile prediction transforms.

    All payload leaves carry the tile batch on axis 0, and decoding any
    subset of tiles must reproduce the exact bits the full batch would (the
    region == full-crop contract of random-access decode)."""

    name: str

    def plan(self, tile: tuple[int, ...], max_levels: int = 5) -> int:
        """Static per-tile-shape config: interp level count (0 when unused)."""
        raise NotImplementedError

    def encode_tiles(self, tiles: torch.Tensor, eb: float, *, order: str, levels: int):
        """[B, *tile] -> (payload dict of [B, ...] tensors, recon [B, *tile]);
        ``recon`` is the decode's own output."""
        raise NotImplementedError

    def decode_tiles(self, payload: dict, eb: float, *, tile: tuple[int, ...],
                     order: str, levels: int) -> torch.Tensor:
        """Payload dict ([B, ...]) -> recon [B, *tile] float32."""
        raise NotImplementedError

    def lane_bytes(self, payload: dict, i: int, backend: str) -> bytes:
        """Serialize tile ``i`` of a payload to one lane."""
        raise NotImplementedError

    def lane_bytes_batch(self, payload: dict, n: int, backend: str) -> list[bytes]:
        """Serialize all ``n`` tiles of a payload.  The default loops
        :meth:`lane_bytes`; a predictor may batch the device encode across
        lanes."""
        return [self.lane_bytes(payload, i, backend) for i in range(n)]

    def parse_lane(self, blob: bytes, *, tile: tuple[int, ...], levels: int,
                   device: torch.device) -> dict:
        """Inverse of :meth:`lane_bytes`: one lane -> unbatched payload on
        ``device``."""
        raise NotImplementedError


@register_predictor
class _LorenzoTiles(TilePredictor):
    """Prequant + integer Lorenzo per tile (each tile its own zero boundary).

    Payload: ``{"codes": int32 [B, *tile]}`` on the tiles' device."""

    name = "lorenzo"

    def plan(self, tile, max_levels=5):
        return 0

    def encode_tiles(self, tiles, eb, *, order, levels):
        from repro_torch.kernels import ops

        payload = {"codes": ops.lorenzo_quant_tiles_op(tiles, eb)}
        recon = self.decode_tiles(payload, eb, tile=tuple(tiles.shape[1:]),
                                  order=order, levels=levels)
        return payload, recon

    def decode_tiles(self, payload, eb, *, tile, order, levels):
        from repro_torch.kernels import ops

        return ops.lorenzo_decode_tiles_op(payload["codes"], eb)

    def lane_bytes(self, payload, i, backend):
        from repro_torch.sz import entropy

        return entropy.encode_codes(payload["codes"][i], backend)

    def lane_bytes_batch(self, payload, n, backend):
        from repro_torch.sz import entropy

        return entropy.encode_codes_lanes(payload["codes"][:n], backend)

    @obs.spanned("lane.parse")
    def parse_lane(self, blob, *, tile, levels, device):
        from repro_torch.sz import entropy

        return {"codes": entropy.decode_codes(blob, tile, device=device)}


# Interp lane layout (inside the GWTC container, the reference's):
#   n_out u32 | zlen u32 | zlib(idx u32[n_out] + val f32[n_out]) | RPRE codes
# Codes live on the per-tile *interp-padded* shape, derived from the
# container's (tile, levels) as ``_padded_shape(tile, levels)``.
_INTERP_LANE_HDR = struct.Struct("<II")


def _interp_lane(idx: np.ndarray, val: np.ndarray, code_blob: bytes) -> bytes:
    out = zlib.compress(idx.astype(np.uint32).tobytes() + val.astype(np.float32).tobytes(), 6)
    return _INTERP_LANE_HDR.pack(idx.size, len(out)) + out + code_blob


@register_predictor
class _InterpTiles(TilePredictor):
    """SZ3-style multi-level interpolation over the tile batch.

    Payload: ``{"codes": int32, "omask": bool, "ovals": f32}`` on the
    per-tile interp-padded grid ([B, *padded_tile]).  Each tile is its own
    prediction domain, and the decode is elementwise in the batch axis, so
    a region decode equals the full decode's crop bit for bit."""

    name = "interp"

    def plan(self, tile, max_levels=5):
        return _num_levels(tile, max_levels)

    def encode_tiles(self, tiles, eb, *, order, levels):
        tile = tuple(tiles.shape[1:])
        xp = pad_edge(tiles, _padded_shape(tile, levels), first_axis=1)
        codes, omask, ovals, recon, _ = interp_encode_batch(xp, eb, levels, order)
        payload = {"codes": codes, "omask": omask, "ovals": ovals}
        return payload, recon[(slice(None),) + tuple(slice(0, d) for d in tile)]

    def decode_tiles(self, payload, eb, *, tile, order, levels):
        recon = _interp_decode_padded(payload["codes"], payload["omask"], payload["ovals"],
                                      eb, levels, order)
        return recon[(slice(None),) + tuple(slice(0, d) for d in tile)]

    def lane_bytes(self, payload, i, backend):
        from repro_torch.sz import entropy

        idx = torch.nonzero(payload["omask"][i].reshape(-1)).reshape(-1)
        val = payload["ovals"][i].reshape(-1)[idx]
        return _interp_lane(idx.cpu().numpy(), val.cpu().numpy(),
                            entropy.encode_codes(payload["codes"][i], backend))

    def lane_bytes_batch(self, payload, n, backend):
        """All lanes at once: the outliers found on the device and only they
        copied back; the codes of every lane in one
        ``entropy.encode_codes_lanes`` call."""
        from repro_torch.sz import entropy

        nz = torch.nonzero(payload["omask"][:n].reshape(n, -1))  # (lane, index), in order
        val = payload["ovals"][:n].reshape(n, -1)[nz[:, 0], nz[:, 1]].cpu().numpy()
        nz = nz.cpu().numpy()
        cuts = np.searchsorted(nz[:, 0], np.arange(n + 1))
        blobs = entropy.encode_codes_lanes(payload["codes"][:n], backend)
        return [_interp_lane(nz[a:b, 1], val[a:b], blob)
                for a, b, blob in zip(cuts[:-1], cuts[1:], blobs)]

    @obs.spanned("lane.parse")
    def parse_lane(self, blob, *, tile, levels, device):
        from repro_torch.sz import entropy

        pshape = _padded_shape(tile, levels)
        n_out, zlen = _INTERP_LANE_HDR.unpack_from(blob, 0)
        off = _INTERP_LANE_HDR.size
        with obs.span("lane.inflate"):
            raw = zlib.decompress(blob[off : off + zlen])
        idx = np.frombuffer(raw, np.uint32, n_out)
        val = np.frombuffer(raw, np.float32, n_out, offset=4 * n_out)
        omask, ovals = scatter_outliers(idx, val, pshape, device)
        return {"codes": entropy.decode_codes(blob[off + zlen :], pshape, device=device),
                "omask": omask, "ovals": ovals}
