"""Input-shape cells (assigned per arch) and shape-only inputs, port of
``repro/launch/shapes.py``.

Every cell resolves to (step kind, a tree of tensors on the ``meta``
device): shapes and dtypes with no storage, the analogue of the
reference's ``ShapeDtypeStruct`` trees, which the dry run traces from.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs import get_config, get_family, long_context_ok


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs."""
    if shape == "long_500k" and not long_context_ok(arch):
        return False, "pure full attention at 500k context — skipped per brief"
    return True, ""


def sds(shape, dtype) -> torch.Tensor:
    """A shape-only tensor (``meta``: no storage)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(arch: str, shape: str, *, reduced: bool = False) -> dict:
    """Shape-only stand-ins for every model input of this cell:
    ``{"batch", "cell", "cfg"}`` (and ``"ctx"``, the cache length, for a
    decode cell)."""
    cell = SHAPES[shape]
    B, S = cell.global_batch, cell.seq_len
    if reduced:
        B, S = max(B // 64, 1), min(S, 64)
    return cell_specs(get_config(arch, reduced=reduced), get_family(arch), cell, B, S)


def cell_specs(cfg, family: str, cell: ShapeCell, B: int, S: int) -> dict:
    """:func:`input_specs` of a model config and family at batch ``B`` and
    sequence (or cache) length ``S``."""
    mrope = cfg.attn is not None and cfg.attn.mrope_sections is not None

    if cell.kind in ("train", "prefill"):
        batch = {"tokens": sds((B, S), torch.int32)}
        if cell.kind == "train":
            batch["targets"] = sds((B, S), torch.int32)
        if mrope:
            batch["positions"] = sds((B, 3, S), torch.int32)
        if family == "encdec":
            batch["enc_feats"] = sds((B, cfg.enc_seq, cfg.d_model), cfg.compute_dtype)
        return {"batch": batch, "cell": cell, "cfg": cfg}

    # decode: one new token against a ctx-length cache
    batch = {"token": sds((B, 1), torch.int32), "pos": sds((), torch.int32)}
    if family == "encdec":
        batch["enc_out"] = sds((B, cfg.enc_seq, cfg.d_model), cfg.compute_dtype)
    return {"batch": batch, "cell": cell, "cfg": cfg, "ctx": S}
