"""Out-of-core streaming execution layer (port of ``repro/exec``;
docs/STREAMING.md).

Turns compression into a plan of per-tile-batch tasks run by a
bounded-memory executor:

* :mod:`repro_torch.exec.sources`: uniform tile access over ndarray /
  memmap / ``.npy`` path / slab-iterator inputs,
* :mod:`repro_torch.exec.plan`: batch sizing against a byte budget,
* :mod:`repro_torch.exec.writer`: the incremental append-only ``GWTC``
  writer with its commit journal and the multi-field ``GWDS`` writer
  (indexes written as footers on ``finalize()``),
* :mod:`repro_torch.exec.executor`: the streaming loop (the device stage of
  batch k+1 overlaps the host append of batch k),
* :mod:`repro_torch.exec.cache`: the size-capped, thread-safe LRU tile
  cache behind ``repro_torch.api.CompressedVolume`` region reads, and the
  cross-request :class:`DecodeBatcher` of the serving daemon.

The public entry point is :func:`repro_torch.api.compress_stream`; a
field streams into a GWDS envelope through ``GWDSWriter.stream_field``.
"""
from repro_torch.exec.cache import DecodeBatcher, TileCache
from repro_torch.exec.executor import StreamReport, stream_compress
from repro_torch.exec.plan import StreamPlan, max_inflight_tiles, plan_stream, tile_working_bytes
from repro_torch.exec.sources import ArraySource, IterSource, NpyFileSource, TileSource, as_source
from repro_torch.exec.writer import GWDSWriter, GWTCWriter, journal_path

__all__ = [
    "ArraySource",
    "DecodeBatcher",
    "GWDSWriter",
    "GWTCWriter",
    "IterSource",
    "NpyFileSource",
    "StreamPlan",
    "StreamReport",
    "TileCache",
    "TileSource",
    "as_source",
    "journal_path",
    "max_inflight_tiles",
    "plan_stream",
    "stream_compress",
    "tile_working_bytes",
]
