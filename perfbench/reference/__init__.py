"""The benchmark's plain reference: a decoder of the program's containers
written from the format documents, in numpy and plain torch.

It imports nothing of the program.  :func:`decode` reads a GWTC container's
bytes and returns what a reader of that container must get back, with the
checks that need the original field (codes, CRCs); the benchmark holds the
program's outputs against it.  ``dtype`` below float32 gives the control:
the same arithmetic in a lower precision.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference import container as C
from perfbench.reference import enhancer as E
from perfbench.reference import huffman as H
from perfbench.reference import predictors as P

_INTERP_HDR = struct.Struct("<II")


@dataclass
class Decoded:
    eb: float
    sz: torch.Tensor  # the SZ reconstruction, volume shape
    out: torch.Tensor  # what a reader gets: enhanced where a model rides along
    codes_bad: int  # codes that differ from the ones the input derives (-1: no input)
    crc_bad: int  # lanes whose bytes fail their index CRC-32
    model: dict | None
    exact: bool  # float32 arithmetic (not the control's lower precision)


def _lane_codes(blobs: list[bytes], n: int, device) -> torch.Tensor:
    parsed = [C.parse_entropy(b) for b in blobs]
    if all(isinstance(p, C.HuffmanLane) for p in parsed):
        return H.decode_lanes(parsed, device)
    return torch.stack([torch.from_numpy(p).to(device) if isinstance(p, np.ndarray)
                        else H.decode_lanes([p], device)[0] for p in parsed])


def decode(blob: bytes, device, *, x: torch.Tensor | None = None,
           dtype=torch.float32, enhance: bool = True) -> Decoded:
    """Decode a GWTC container; ``x`` (the original field, on ``device``)
    adds the code check; ``enhance=False`` leaves an attached model
    unapplied (``out`` is then the SZ field)."""
    con = C.parse_gwtc(blob)
    tile, eb = con.tile, con.eb_abs
    xt = None if x is None else P.split_tiles(x.to(torch.float32), tile)
    if con.predictor == "lorenzo":
        codes = _lane_codes(con.lanes, int(np.prod(tile)), device).view(-1, *tile)
        bad = -1 if xt is None else int((P.lorenzo_codes(xt, eb) != codes).sum())
        tiles = P.lorenzo_decode(codes, eb, dtype)
    else:
        pshape = P.interp_padded(tile, con.levels)
        outl, code_blobs = [], []
        for lane in con.lanes:
            n_out, zlen = _INTERP_HDR.unpack_from(lane, 0)
            raw = zlib.decompress(lane[8:8 + zlen])
            outl.append((np.frombuffer(raw, np.uint32, n_out),
                         np.frombuffer(raw, np.float32, n_out, offset=4 * n_out)))
            code_blobs.append(lane[8 + zlen:])
        codes = _lane_codes(code_blobs, int(np.prod(pshape)), device).view(-1, *pshape)
        masks = [P.scatter_outliers(i, v, pshape, device) for i, v in outl]
        omask = torch.stack([m for m, _ in masks])
        ovals = torch.stack([v for _, v in masks])
        del masks
        xp = None if xt is None else P.pad_edge(xt, pshape, first_axis=1)
        tiles, bad = P.interp_decode(codes, omask, ovals, eb, con.levels, con.order, x=xp,
                                     dtype=dtype)
        del omask, ovals, xp
        tiles = tiles[:, : tile[0], : tile[1], : tile[2]]
        bad = -1 if xt is None else bad
    del codes
    sz = P.stitch_tiles(tiles.to(torch.float32), con.shape, tile).contiguous()
    model = None
    out = sz
    if enhance and "gwlz" in con.extras:
        model = E.parse_model(con.extras["gwlz"])
        enh = E.enhance_tiles(tiles.to(torch.float32).contiguous(), model, dtype=dtype)
        out = P.stitch_tiles(enh, con.shape, tile).contiguous()
    return Decoded(eb, sz, out, bad, con.crc_bad, model, dtype == torch.float32)


def rel_eb_abs(x: torch.Tensor, rel_eb: float) -> float:
    """The absolute bound of a relative one: rel * (max - min), the range a
    float32 subtraction, floored at the least normal float32."""
    mn, mx = torch.aminmax(x)
    return rel_eb * max(float(mx - mn), float(np.finfo(np.float32).tiny))
