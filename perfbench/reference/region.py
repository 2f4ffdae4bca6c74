"""Plain random-access decode of a Lorenzo GWTC container: only the lanes a
set of boxes touches are read, checked against their index CRC-32,
decoded, enhanced with the attached model, and cropped to each box.

Written from the format documents as ``container.py`` is; the arithmetic
is ``predictors.lorenzo_decode`` and ``enhancer.enhance_tiles``, so a box
equals the crop of the whole decode.  ``dtype`` below float32 gives the
control.
"""
from __future__ import annotations

import itertools
import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference import container as C
from perfbench.reference import enhancer as E
from perfbench.reference import huffman as H
from perfbench.reference import predictors as P


@dataclass
class Tiles:
    tile: tuple[int, ...]
    grid: tuple[int, ...]
    eb: float
    out: dict  # tile id -> what a reader gets (enhanced where a model rides along)
    codes_bad: int  # codes of those tiles that differ from the input's (-1: no input)
    crc_bad: int  # lanes of those tiles whose bytes fail their index CRC-32


def box_tiles(box, tile, grid) -> list[int]:
    """Row-major ids of the tiles a box ``((lo, hi), ...)`` touches."""
    ranges = [range(lo // t, min(-(-hi // t), g)) for (lo, hi), t, g in zip(box, tile, grid)]
    return [int(np.ravel_multi_index(c, grid)) for c in itertools.product(*ranges)]


def _lane_crcs(blob: bytes, n_tiles: int) -> np.ndarray:
    _extras_off, index_off = struct.unpack_from("<QQ", blob, len(blob) - 16)
    return np.frombuffer(blob, np.uint32, n_tiles, offset=index_off + 8 * n_tiles)


def decode_tiles(blob: bytes, ids, device, *, x: torch.Tensor | None = None,
                 dtype=torch.float32) -> Tiles:
    """Decode the lanes ``ids`` of a Lorenzo container; ``x`` (the original
    field, on ``device``) adds the code check."""
    con = C.parse_gwtc(blob)
    if con.predictor != "lorenzo":
        raise ValueError("the region reference decodes Lorenzo containers only")
    ids = sorted(set(int(i) for i in ids))
    crcs = _lane_crcs(blob, len(con.lanes))
    lanes = [con.lanes[i] for i in ids]
    crc_bad = sum(int(zlib.crc32(b) & 0xFFFFFFFF != int(crcs[i])) for b, i in zip(lanes, ids))
    codes = H.decode_lanes([C.parse_entropy(b) for b in lanes], device).view(-1, *con.tile)
    bad = -1
    if x is not None:
        xt = P.split_tiles(x.to(torch.float32), con.tile)[torch.tensor(ids, device=device)]
        bad = int((P.lorenzo_codes(xt, con.eb_abs) != codes).sum())
        del xt
    tiles = P.lorenzo_decode(codes, con.eb_abs, dtype).to(torch.float32).contiguous()
    if "gwlz" in con.extras:
        tiles = E.enhance_tiles(tiles, E.parse_model(con.extras["gwlz"]), dtype=dtype)
    return Tiles(con.tile, con.grid, con.eb_abs, dict(zip(ids, tiles)), bad, crc_bad)


def crop(dec: Tiles, box) -> torch.Tensor:
    """The box ``((lo, hi), ...)`` cut from the decoded tiles it touches."""
    lo_t = [lo // t for (lo, _hi), t in zip(box, dec.tile)]
    n_t = [min(-(-hi // t), g) - a for (_lo, hi), t, g, a in zip(box, dec.tile, dec.grid, lo_t)]
    ids = box_tiles(box, dec.tile, dec.grid)
    block = torch.stack([dec.out[i] for i in ids])
    block = P.stitch_tiles(block, [n * t for n, t in zip(n_t, dec.tile)], dec.tile)
    return block[tuple(slice(lo - a * t, hi - a * t)
                       for (lo, hi), a, t in zip(box, lo_t, dec.tile))]
