"""Error-bounded lossy compression substrate: the monolithic SZJX compressor
and the tiled GWTC engine."""
from repro_torch.sz.artifact import from_bytes, register_container, sniff_magic
from repro_torch.sz.predictor import interp_decode, interp_encode
from repro_torch.sz.szjax import SZCompressed, SZCompressor, compress, decompress
from repro_torch.sz.tiled import (
    TiledCompressed,
    compress_tiled,
    decompress_region,
    decompress_tiled,
)

__all__ = [
    "from_bytes",
    "register_container",
    "sniff_magic",
    "interp_encode",
    "interp_decode",
    "SZCompressed",
    "SZCompressor",
    "compress",
    "decompress",
    "TiledCompressed",
    "compress_tiled",
    "decompress_tiled",
    "decompress_region",
]
