"""GWLZ end-to-end pipeline (paper Figs. 1-2), tiled half, port of
``repro/core/pipeline.py``: tiled SZ compression, group-wise enhancer
training on the decoder's own tiles, the model blob attached to the GWTC
container's extras (fp32, §4.1), and enhanced full and region decode.

The reference reaches its tiled engine through ``SZCompressor``, whose
default predictor is interp; the port has no ``SZCompressor`` yet, so
:class:`GWLZ` calls :func:`repro_torch.sz.compress_tiled` with the
predictor given per call (``"lorenzo"``, the only one ported).  The
monolithic SZJX path comes with the interp port.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.enhancer import PARAM_NAMES, GroupEnhancers
from repro_torch.core.trainer import (
    GWLZModel,
    GWLZTrainConfig,
    clock,
    enhance_tiles,
    train_enhancers_tiled,
)
from repro_torch.errors import CorruptContainerError
from repro_torch.kernels.ops import resolve_device
from repro_torch.sz import tiled

_GW_MAGIC = b"GWLZ"
_GW_HEAD = struct.Struct("<4sIIIB3x")  # magic, n_groups, channels, strategy, residual
_STRATEGY_IDS = {"quantile": 0, "range": 1, "log": 2}
_STRATEGY_NAMES = {v: k for k, v in _STRATEGY_IDS.items()}


# ---------------------------------------------------------------------------
# model (de)serialization -- extras["gwlz"] in the container
# ---------------------------------------------------------------------------


def _leaf_shapes(G: int, C: int) -> list[tuple[str, tuple[int, ...]]]:
    """The blob's leaves in order: params in sorted-key order, then BN
    state, edges and rscale, each in the reference's layout."""
    params = {"b1": (G, C), "b2": (G, 1), "beta": (G, C), "gamma": (G, C),
              "w1": (G, 3, 3, 1, C), "w2": (G, 3, 3, C, 1)}
    return ([(k, params[k]) for k in PARAM_NAMES]
            + [("mean", (G, C)), ("var", (G, C)), ("edges", (G + 1,)), ("rscale", (G,))])


def serialize_model(model: GWLZModel) -> bytes:
    """The reference's model blob, byte for byte."""
    cfg = model.cfg
    out = [_GW_HEAD.pack(_GW_MAGIC, cfg.n_groups, cfg.channels, _STRATEGY_IDS[cfg.strategy],
                         1 if cfg.residual_learning else 0)]
    leaves = {**model.params, **model.bn_state, "edges": model.edges, "rscale": model.rscale}
    for name, shape in _leaf_shapes(cfg.n_groups, cfg.channels):
        arr = leaves[name].detach().to("cpu", torch.float32).numpy().reshape(shape)
        out.append(struct.pack("<I", arr.size) + arr.tobytes())
    return b"".join(out)


def deserialize_model(blob: bytes, device=None) -> GWLZModel:
    """Parse a model blob (either package's) onto ``device``."""
    device = resolve_device(device)
    try:
        magic, G, C, strat, resid = _GW_HEAD.unpack_from(blob, 0)
    except struct.error as e:
        raise CorruptContainerError(f"truncated GWLZ model blob: {e}", offset=0) from e
    if magic != _GW_MAGIC or strat not in _STRATEGY_NAMES:
        raise CorruptContainerError("bad GWLZ model blob header", offset=0,
                                    actual=(bytes(magic), int(strat)))
    cfg = GWLZTrainConfig(n_groups=G, channels=C, strategy=_STRATEGY_NAMES[strat],
                          residual_learning=bool(resid))
    off = _GW_HEAD.size
    leaves = {}
    for name, shape in _leaf_shapes(G, C):
        want = int(np.prod(shape))
        try:
            (n,) = struct.unpack_from("<I", blob, off)
        except struct.error as e:
            raise CorruptContainerError(f"truncated GWLZ model blob: {e}", offset=off) from e
        if n != want or off + 4 + 4 * n > len(blob):
            raise CorruptContainerError(f"GWLZ model leaf {name!r} has a bad extent",
                                        offset=off, expected=want, actual=int(n))
        leaves[name] = np.frombuffer(blob, np.float32, n, offset=off + 4).reshape(shape)
        off += 4 + 4 * n
    enh = GroupEnhancers(G, C, device=device).load(
        {k: leaves[k] for k in PARAM_NAMES}, {k: leaves[k] for k in ("mean", "var")})
    as_t = lambda a: torch.from_numpy(a.copy()).to(device)
    return GWLZModel(enhancers=enh, edges=as_t(leaves["edges"]),
                     rscale=as_t(leaves["rscale"]), cfg=cfg)


# Decode-side cache: region reads decode many small ROIs from one artifact
# and its model blob is the same every time -- parse it once.  Keyed on the
# blob bytes and the device; models are treated as immutable.
_deserialize_model_cached = lru_cache(maxsize=8)(deserialize_model)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


@dataclass
class GWLZStats:
    psnr_sz: float
    psnr_gwlz: float
    cr_sz: float
    cr_gwlz: float
    overhead: float  # extra bytes / sz bytes (paper Table 2 col 5)
    max_err_sz: float
    max_err_gwlz: float
    eb_abs: float
    n_model_params: int
    loss_history: np.ndarray | None = None
    seconds: dict | None = None  # per phase: sz, decode, edges, train, calibrate, gate, enhance


class GWLZ:
    """compress_tiled(): tiled SZ compression + group-wise enhancer training.
    decode(): tiled decode + group-wise enhancement per tile, full or ROI.

    Entry points take ``device=None``, meaning the CUDA device (which must
    exist); pass ``device="cpu"`` to run the plain versions."""

    def __init__(self, train_cfg: GWLZTrainConfig = GWLZTrainConfig(),
                 clamp_to_bound: bool = False):
        self.train_cfg = train_cfg
        self.clamp_to_bound = clamp_to_bound

    def _clamp(self, artifact) -> float | None:
        return artifact.eb_abs if self.clamp_to_bound else None

    def compress_tiled(self, x, tile=(64, 64, 64), *, rel_eb: float | None = None,
                       abs_eb: float | None = None, predictor: str = "lorenzo",
                       callback=None, device=None):
        """Tile-grid GWLZ: tiled SZ compress, then ONE batched enhancer
        training pass over the per-tile slice stack; the model rides in the
        GWTC extras.  Returns (TiledCompressed, GWLZStats)."""
        device = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32).to(device)
        if x.ndim != 3:
            raise ValueError("tiled GWLZ needs a 3D volume (enhancers are 2D CNNs)")
        t0 = clock(device)
        artifact, recon = tiled.compress_tiled(x, tile, rel_eb=rel_eb, abs_eb=abs_eb,
                                               predictor=predictor, device=device)
        sz_bytes = artifact.nbytes
        t1 = clock(device)
        # Train on the decoder's own tiles: the exact arrays decompression
        # will feed the enhancer.
        recon_tiles, _ = tiled.decode_lanes(artifact, range(artifact.n_tiles), device=device)
        resid_tiles = tiled.split_tiles(tiled.pad_to_tiles(x, artifact.tile),
                                        artifact.tile) - recon_tiles
        t2 = clock(device)
        model, history = train_enhancers_tiled(recon_tiles, resid_tiles, self.train_cfg,
                                               callback=callback, device=device)
        artifact.extras["gwlz"] = serialize_model(model)
        t3 = clock(device)
        out = enhance_tiles(recon_tiles, model, clamp_eb=self._clamp(artifact))
        enhanced = tiled.stitch_tiles(out, artifact.grid)[tuple(slice(0, d) for d in x.shape)]
        seconds = {"sz": t1 - t0, "decode": t2 - t1, **history["seconds"],
                   "enhance": clock(device) - t3}
        total_bytes = artifact.nbytes
        stats = GWLZStats(
            psnr_sz=float(metrics.psnr(x, recon)),
            psnr_gwlz=float(metrics.psnr(x, enhanced)),
            cr_sz=float(4 * x.numel() / sz_bytes),
            cr_gwlz=float(4 * x.numel() / total_bytes),
            overhead=float((total_bytes - sz_bytes) / sz_bytes),
            max_err_sz=float(metrics.max_abs_err(x, recon)),
            max_err_gwlz=float(metrics.max_abs_err(x, enhanced)),
            eb_abs=artifact.eb_abs,
            n_model_params=model.n_params,
            loss_history=history["loss"],
            seconds=seconds,
        )
        return artifact, stats

    def _tile_enhancer(self, artifact, device):
        """Per-tile enhancement transform for decoded tile batches, or None
        when no model is attached."""
        blob = artifact.extras.get("gwlz")
        if blob is None:
            return None
        model = _deserialize_model_cached(blob, device)
        clamp = self._clamp(artifact)
        return lambda tiles: enhance_tiles(tiles, model, clamp_eb=clamp)

    def decode(self, artifact, roi=None, *, device=None) -> torch.Tensor:
        """Decode a tiled artifact, enhanced when a model is attached: the
        full volume, or just ``roi`` (only the intersecting lanes decode;
        bit-identical to the full decode's crop)."""
        if not isinstance(artifact, tiled.TiledCompressed):
            raise TypeError("the port decodes tiled (GWTC) artifacts; the monolithic "
                            "SZJX container is not ported yet")
        device = resolve_device(device)
        transform = self._tile_enhancer(artifact, device)
        if roi is None:
            return tiled.decompress_tiled(artifact, device=device, tile_transform=transform)
        return tiled.decompress_region(artifact, roi, device=device, tile_transform=transform)

    def decode_tiles(self, artifact, lane_ids, *, device=None) -> torch.Tensor:
        """Decode the named lanes to final per-tile values (enhanced when a
        model is attached): ``[len(ids), *tile]``."""
        device = resolve_device(device)
        recon, _, bad = tiled.decode_lanes(artifact, lane_ids, with_mask=True, device=device)
        return tiled.apply_tile_transform(self._tile_enhancer(artifact, device), recon, bad,
                                          artifact.fill_value)

    def decompress_tiled(self, artifact, *, device=None) -> torch.Tensor:
        return self.decode(artifact, device=device)

    def decompress_region(self, artifact, roi, *, device=None) -> torch.Tensor:
        """ROI decode touching only intersecting tiles; enhancement (when a
        model is attached) runs on exactly those tiles."""
        return self.decode(artifact, roi, device=device)
