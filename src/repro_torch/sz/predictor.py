"""Lorenzo prediction and the tile-predictor registry (port of the Lorenzo
half of ``repro/sz/predictor.py``: ``:37-59``, ``:269-386``).

Values are prequantized onto the 2*eb grid and an exact integer Lorenzo
stencil decorrelates them; reconstruction is an int32 cumsum along each
axis.  The whole-volume encode (the monolithic SZJX path) runs on the
``lorenzo_quant`` kernel, the per-tile one on ``lorenzo_quant_tiles``.  The
tiled engine dispatches its per-tile transform through
:func:`get_predictor`; only ``"lorenzo"`` is registered in the port so far
(the interp predictor is ROADMAP.md Queue 1 item 6).  The wire ids are the
reference's, so containers name predictors identically.
"""
from __future__ import annotations

import torch

from repro_torch.sz.quantizer import dequantize_pre


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

    def parse_lane(self, blob, *, tile, levels, device):
        from repro_torch.sz import entropy

        return {"codes": entropy.decode_codes(blob, tile, device=device)}
