"""GWLZ end-to-end pipeline (paper Figs. 1-2), port of
``repro/core/pipeline.py``: SZ compression (monolithic SZJX or tiled
GWTC), group-wise enhancer training on the decoder's own data, the model
blob attached to the container's extras (fp32, §4.1), and enhanced full
and region decode.

As in the reference, :class:`GWLZ` reaches both containers through its
``SZCompressor``, whose default predictor is interp; that predictor is not
ported yet, so pass ``sz=SZCompressor("lorenzo")``.
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
    enhance,
    enhance_tiles,
    train_enhancers,
    train_enhancers_tiled,
)
from repro_torch.errors import CorruptContainerError
from repro_torch.kernels.ops import resolve_device
from repro_torch.sz import tiled
from repro_torch.sz.szjax import SZCompressed, SZCompressor

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
    """compress(): SZ3-class compression + group-wise enhancer training.
    decode(): SZ decode + group-wise enhancement (Figs. 1-2), full or ROI.

    The canonical entry points are container-agnostic: :meth:`compress_volume`
    returns a :class:`repro_torch.api.CompressedVolume` handle and
    :meth:`decode` takes either artifact (monolithic ``SZJX`` or tiled
    ``GWTC``) plus an optional ROI; ``decompress*`` are shims over
    :meth:`decode`.  Entry points take ``device=None``, meaning the CUDA
    device (which must exist); pass ``device="cpu"`` to run the plain
    versions."""

    def __init__(self, sz: SZCompressor | None = None,
                 train_cfg: GWLZTrainConfig = GWLZTrainConfig(),
                 clamp_to_bound: bool = False):
        self.sz = sz or SZCompressor()
        self.train_cfg = train_cfg
        self.clamp_to_bound = clamp_to_bound

    def _clamp(self, artifact) -> float | None:
        return artifact.eb_abs if self.clamp_to_bound else None

    # -- shared orchestration core (monolithic and tiled paths) ----------------

    def _finish_compress(self, x, artifact, recon, *, train_fn, enhance_fn, seconds: dict,
                         device):
        """The train + attach + enhance + stats sequence both compression
        front ends share.  ``seconds`` holds the phases before training."""
        sz_bytes = artifact.nbytes
        model, history = train_fn()
        artifact.extras["gwlz"] = serialize_model(model)
        t = clock(device)
        enhanced = enhance_fn(model)
        seconds = {**seconds, **history["seconds"], "enhance": clock(device) - t}
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

    def compress(self, x, *, rel_eb: float | None = None, abs_eb: float | None = None,
                 callback=None, device=None) -> tuple[SZCompressed, GWLZStats]:
        """Monolithic GWLZ: SZJX compress of the whole volume, then the
        enhancers train on its slices (the compress-time reconstruction is
        the decoder's own output).  Returns (SZCompressed, GWLZStats)."""
        device = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32).to(device)
        t0 = clock(device)
        artifact, recon = self.sz.compress(x, rel_eb=rel_eb, abs_eb=abs_eb, device=device)
        artifact.to_bytes()  # the serialization (cached) belongs to the sz phase
        t1 = clock(device)
        return self._finish_compress(
            x, artifact, recon,
            train_fn=lambda: train_enhancers(recon, x - recon, self.train_cfg,
                                             callback=callback, device=device),
            enhance_fn=lambda m: enhance(recon, m, clamp_eb=self._clamp(artifact),
                                         device=device),
            seconds={"sz": t1 - t0}, device=device)

    def compress_tiled(self, x, tile=(64, 64, 64), *, rel_eb: float | None = None,
                       abs_eb: float | None = None, predictor: str | None = None,
                       callback=None, device=None):
        """Tile-grid GWLZ: tiled SZ compress (``predictor`` overrides the
        SZCompressor's), then ONE batched enhancer training pass over the
        per-tile slice stack; the model rides in the GWTC extras.  Returns
        (TiledCompressed, GWLZStats)."""
        device = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32).to(device)
        if x.ndim != 3:
            raise ValueError("tiled GWLZ needs a 3D volume (enhancers are 2D CNNs)")
        t0 = clock(device)
        artifact, recon = self.sz.compress_tiled(x, tile, rel_eb=rel_eb, abs_eb=abs_eb,
                                                 predictor=predictor, device=device)
        t1 = clock(device)
        # Train on the decoder's own tiles: the exact arrays decompression
        # will feed the enhancer.
        recon_tiles, _ = tiled.decode_lanes(artifact, range(artifact.n_tiles), device=device)
        resid_tiles = tiled.split_tiles(tiled.pad_to_tiles(x, artifact.tile),
                                        artifact.tile) - recon_tiles
        t2 = clock(device)

        def enhance_fn(model):
            out = enhance_tiles(recon_tiles, model, clamp_eb=self._clamp(artifact))
            return tiled.stitch_tiles(out, artifact.grid)[tuple(slice(0, d) for d in x.shape)]

        return self._finish_compress(
            x, artifact, recon,
            train_fn=lambda: train_enhancers_tiled(recon_tiles, resid_tiles, self.train_cfg,
                                                   callback=callback, device=device),
            enhance_fn=enhance_fn, seconds={"sz": t1 - t0, "decode": t2 - t1}, device=device)

    # -- canonical container-agnostic entry points -----------------------------

    def compress_volume(self, x, *, tiled: bool = False, tile=(64, 64, 64),
                        rel_eb: float | None = None, abs_eb: float | None = None,
                        predictor: str | None = None, callback=None, device=None):
        """Compress + train + attach, returning a
        :class:`repro_torch.api.CompressedVolume` handle (``vol.stats``
        carries the paper metrics; decode and slicing route back through
        this pipeline, so the attached enhancer is always applied)."""
        from repro_torch.api import CompressedVolume

        device = resolve_device(device)
        if tiled:
            artifact, stats = self.compress_tiled(
                x, tile, rel_eb=rel_eb, abs_eb=abs_eb, predictor=predictor,
                callback=callback, device=device)
        else:
            if predictor is not None and predictor != self.sz.predictor:
                raise ValueError(
                    "monolithic predictor is fixed by the SZCompressor; "
                    f"construct GWLZ(sz=SZCompressor(predictor={predictor!r}))")
            artifact, stats = self.compress(x, rel_eb=rel_eb, abs_eb=abs_eb,
                                            callback=callback, device=device)
        return CompressedVolume(artifact, stats=stats, pipeline=self, device=device)

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
        """Container-agnostic decode, enhanced when a model is attached: the
        full volume, or just ``roi``.  Tiled artifacts decode only the lanes
        an ROI intersects; monolithic ones decode whole and crop after
        enhancement.  Either way the ROI equals the full decode's crop bit
        for bit."""
        device = resolve_device(device)
        if isinstance(artifact, tiled.TiledCompressed):
            transform = self._tile_enhancer(artifact, device)
            if roi is None:
                return tiled.decompress_tiled(artifact, device=device,
                                              tile_transform=transform)
            return tiled.decompress_region(artifact, roi, device=device,
                                           tile_transform=transform)
        if not isinstance(artifact, SZCompressed):
            raise TypeError(f"cannot decode a {type(artifact).__name__}")
        recon = self.sz.decompress(artifact, device=device)
        blob = artifact.extras.get("gwlz")
        if blob is not None:
            recon = enhance(recon, _deserialize_model_cached(blob, device),
                            clamp_eb=self._clamp(artifact), device=device)
        if roi is None:
            return recon
        bounds = tiled.normalize_roi(roi, tuple(artifact.shape))
        return recon[tuple(slice(lo, hi) for lo, hi in bounds)]

    def decode_tiles(self, artifact, lane_ids, *, device=None) -> torch.Tensor:
        """Decode the named lanes of a tiled artifact to final per-tile
        values (enhanced when a model is attached): ``[len(ids), *tile]``."""
        device = resolve_device(device)
        recon, _, bad = tiled.decode_lanes(artifact, lane_ids, with_mask=True, device=device)
        return tiled.apply_tile_transform(self._tile_enhancer(artifact, device), recon, bad,
                                          artifact.fill_value)

    # -- per-container shims ---------------------------------------------------

    def decompress(self, artifact: SZCompressed, *, device=None) -> torch.Tensor:
        return self.decode(artifact, device=device)

    def decompress_tiled(self, artifact, *, device=None) -> torch.Tensor:
        return self.decode(artifact, device=device)

    def decompress_region(self, artifact, roi, *, device=None) -> torch.Tensor:
        """ROI decode touching only intersecting tiles; enhancement (when a
        model is attached) runs on exactly those tiles."""
        return self.decode(artifact, roi, device=device)


def quick_compress(x, rel_eb=1e-3, n_groups=20, epochs=60, *, device=None, **kw):
    """Convenience entry point (reduced epochs), on the reference's default
    ``SZCompressor()``, whose interp predictor is not ported yet: until it
    is, this raises ``NotImplementedError``; use
    ``GWLZ(sz=SZCompressor("lorenzo"), ...).compress``."""
    cfg = GWLZTrainConfig(n_groups=n_groups, epochs=epochs, **kw)
    return GWLZ(train_cfg=cfg).compress(x, rel_eb=rel_eb, device=device)
