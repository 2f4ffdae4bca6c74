"""Monolithic SZ compressor and its ``SZJX`` container, port of
``repro/sz/szjax.py``.

``compress`` returns both the serializable artifact and the decompressor-
visible reconstruction (GWLZ trains its enhancers on it without a second
decompress pass).  With the Lorenzo predictor the whole volume is one
prediction domain and one entropy stream: prequantization and the 3-axis
Lorenzo difference run on the ``lorenzo_quant`` kernel, the stream on the
Huffman kernels.  Containers are byte-identical to the reference's.

The interp predictor (the reference's default) is not ported yet: asking
for it raises :class:`NotImplementedError` (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.errors import CorruptContainerError
from repro_torch.kernels.ops import resolve_device
from repro_torch.sz import artifact as A
from repro_torch.sz import predictor as P
from repro_torch.sz.entropy import decode_codes, encode_codes
from repro_torch.sz.quantizer import resolve_eb

_HDR = struct.Struct("<4sBBBBQ")  # magic, ndim, predictor, order, levels, eb bits as u64
_MAGIC = A.SZJX_MAGIC
# Wire ids are shared with the GWTC container (canonical registry ids).
_PRED = P.PRED_IDS
_PRED_INV = P.PRED_NAMES
_ORD = P.ORDER_IDS
_ORD_INV = P.ORDER_NAMES
_PORTED_PREDICTORS = ("lorenzo",)


def require_ported(predictor: str) -> None:
    """Raise for a predictor the reference has and the port has not yet."""
    if predictor not in _PORTED_PREDICTORS:
        raise NotImplementedError(
            f"the {predictor!r} predictor is not ported yet (ROADMAP.md Queue 1 item 6); "
            f"ported: {list(_PORTED_PREDICTORS)}")


@dataclass
class SZCompressed:
    """Self-describing compressed artifact (all host-side)."""

    shape: tuple[int, ...]
    padded_shape: tuple[int, ...]
    levels: int
    eb_abs: float
    predictor: str
    order: str
    code_blob: bytes
    outlier_idx: np.ndarray  # int64 flat indices into the padded volume
    outlier_val: np.ndarray  # float32 exact values
    extras: dict = field(default_factory=dict)  # e.g. attached GWLZ enhancers
    # serialization cache: (extras fingerprint, blob); GWLZ.compress asks for
    # nbytes before and after attaching enhancers, and size_report() again
    _blob_cache: tuple | None = field(default=None, init=False, repr=False, compare=False)

    @property
    def nbytes(self) -> int:
        return len(self.to_bytes())

    def _extras_key(self) -> tuple:
        # exact: holds references to the immutable values, no copies or hashes
        return tuple(sorted(self.extras.items()))

    def size_report(self) -> dict:
        extras = sum(len(v) for v in self.extras.values())
        return {
            "codes": len(self.code_blob),
            "outliers": 8 * self.outlier_idx.size + 4 * self.outlier_val.size,
            "extras": extras,
            "header": _HDR.size + 8 * len(self.shape) * 2 + 16,
            "total": self.nbytes,
        }

    def to_bytes(self) -> bytes:
        key = self._extras_key()
        if self._blob_cache is not None and self._blob_cache[0] == key:
            return self._blob_cache[1]
        blob = self._serialize()
        self._blob_cache = (key, blob)
        return blob

    def _serialize(self) -> bytes:
        hdr = _HDR.pack(_MAGIC, len(self.shape), _PRED[self.predictor], _ORD[self.order],
                        self.levels, int(np.float64(self.eb_abs).view(np.uint64)))
        dims = struct.pack(f"<{len(self.shape)}q", *self.shape)
        pdims = struct.pack(f"<{len(self.padded_shape)}q", *self.padded_shape)
        out_blob = zlib.compress(self.outlier_idx.astype(np.int64).tobytes()
                                 + self.outlier_val.astype(np.float32).tobytes(), 6)
        extras_items = sorted(self.extras.items())
        extras_blob = [struct.pack("<I", len(extras_items))]
        for k, v in extras_items:
            kb = k.encode()
            extras_blob.append(struct.pack("<II", len(kb), len(v)) + kb + bytes(v))
        return b"".join([hdr, dims, pdims,
                         struct.pack("<QQ", self.outlier_idx.size, len(out_blob)), out_blob,
                         struct.pack("<Q", len(self.code_blob)), bytes(self.code_blob),
                         *extras_blob])

    @staticmethod
    def from_bytes(blob) -> "SZCompressed":
        # buffer inputs (a memoryview over an mmap) materialize: the container
        # is whole-volume, so nothing is read lazily, and owning plain bytes
        # lets the mmap close under it
        if not isinstance(blob, (bytes, bytearray)):
            blob = bytes(blob)
        try:
            magic, ndim, pred, order, levels, ebbits = _HDR.unpack_from(blob, 0)
            if magic != _MAGIC:
                raise CorruptContainerError("bad SZJX magic", offset=0, expected=_MAGIC,
                                            actual=bytes(magic))
            if pred not in _PRED_INV or order not in _ORD_INV:
                raise CorruptContainerError("unknown SZJX predictor/order id", offset=6,
                                            actual=(int(pred), int(order)))
            off = _HDR.size
            shape = struct.unpack_from(f"<{ndim}q", blob, off)
            off += 8 * ndim
            pshape = struct.unpack_from(f"<{ndim}q", blob, off)
            off += 8 * ndim
            n_out, out_len = struct.unpack_from("<QQ", blob, off)
            off += 16
            raw = zlib.decompress(blob[off : off + out_len])
            off += out_len
            oidx = np.frombuffer(raw, np.int64, n_out).copy()
            oval = np.frombuffer(raw, np.float32, n_out, offset=8 * n_out).copy()
            (clen,) = struct.unpack_from("<Q", blob, off)
            off += 8
            code_blob = bytes(blob[off : off + clen])
            off += clen
            (n_extras,) = struct.unpack_from("<I", blob, off)
            off += 4
            extras = {}
            for _ in range(n_extras):
                klen, vlen = struct.unpack_from("<II", blob, off)
                off += 8
                k = bytes(blob[off : off + klen]).decode()
                off += klen
                extras[k] = bytes(blob[off : off + vlen])
                off += vlen
        except struct.error as e:
            raise CorruptContainerError(f"truncated SZJX blob: {e}", offset=0) from e
        except zlib.error as e:
            raise CorruptContainerError(f"corrupt SZJX outlier stream: {e}",
                                        offset=_HDR.size) from e
        return SZCompressed(
            shape=tuple(shape), padded_shape=tuple(pshape), levels=levels,
            eb_abs=float(np.uint64(ebbits).view(np.float64)), predictor=_PRED_INV[pred],
            order=_ORD_INV[order], code_blob=code_blob, outlier_idx=oidx,
            outlier_val=oval, extras=extras)


A.register_container(_MAGIC, SZCompressed)


class SZCompressor:
    """Configurable error-bounded compressor (predictor x order x backend).

    The signature and defaults are the reference's (``predictor="interp"``);
    only ``"lorenzo"`` is ported, and the others raise when used.  Entry
    points take ``device=None``, meaning the CUDA device (which must exist);
    pass ``device="cpu"`` to run the plain versions."""

    def __init__(self, predictor: str = "interp", order: str = "cubic",
                 backend: str = "huffman+zlib", max_levels: int = 5):
        if predictor not in _PRED or order not in _ORD:
            raise ValueError(f"unknown predictor/order {predictor!r}/{order!r} "
                             f"(predictors: {sorted(_PRED)}, orders: {sorted(_ORD)})")
        self.predictor = predictor
        self.order = order
        self.backend = backend
        self.max_levels = max_levels

    def compress(self, x, *, rel_eb: float | None = None, abs_eb: float | None = None,
                 device=None) -> tuple[SZCompressed, torch.Tensor]:
        """Returns (artifact, reconstruction on ``device``).  Exactly one of
        rel_eb / abs_eb."""
        require_ported(self.predictor)
        device = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32).to(device)
        eb = resolve_eb(x, rel_eb, abs_eb)
        codes = P.lorenzo_encode(x, eb)
        recon = P.lorenzo_decode(codes, eb)
        artifact = SZCompressed(
            shape=tuple(x.shape), padded_shape=tuple(x.shape), levels=0, eb_abs=eb,
            predictor="lorenzo", order=self.order,
            code_blob=encode_codes(codes, self.backend),
            outlier_idx=np.zeros(0, np.int64), outlier_val=np.zeros(0, np.float32))
        return artifact, recon

    def decompress(self, artifact: SZCompressed, *, device=None) -> torch.Tensor:
        require_ported(artifact.predictor)
        device = resolve_device(device)
        codes = decode_codes(artifact.code_blob, tuple(artifact.shape), device=device)
        return P.lorenzo_decode(codes, artifact.eb_abs)

    def compress_tiled(self, x, tile=(64, 64, 64), *, rel_eb: float | None = None,
                       abs_eb: float | None = None, predictor: str | None = None,
                       device=None):
        """Tile-grid compress into a ``GWTC`` container (random access);
        returns (TiledCompressed, reconstruction).  ``predictor=`` overrides
        ``self.predictor`` for this call."""
        from repro_torch.sz import tiled

        pred = self.predictor if predictor is None else predictor
        require_ported(pred)
        return tiled.compress_tiled(x, tile, rel_eb=rel_eb, abs_eb=abs_eb,
                                    backend=self.backend, predictor=pred, order=self.order,
                                    max_levels=self.max_levels, device=device)

    def decompress_tiled(self, artifact, *, device=None) -> torch.Tensor:
        from repro_torch.sz import tiled

        return tiled.decompress_tiled(artifact, device=device)

    def decompress_region(self, artifact, roi, *, device=None) -> torch.Tensor:
        """Decode only the tiles intersecting ``roi``; equals
        ``decompress_tiled(artifact)[roi]`` bit for bit."""
        from repro_torch.sz import tiled

        return tiled.decompress_region(artifact, roi, device=device)


def compress(x, *, rel_eb=None, abs_eb=None, predictor="interp", order="cubic",
             backend="huffman+zlib", max_levels=5, device=None):
    c = SZCompressor(predictor, order, backend, max_levels)
    return c.compress(x, rel_eb=rel_eb, abs_eb=abs_eb, device=device)


def decompress(artifact: SZCompressed, *, device=None) -> torch.Tensor:
    return SZCompressor(artifact.predictor, artifact.order).decompress(artifact,
                                                                       device=device)
