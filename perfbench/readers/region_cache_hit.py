"""region_cache_hit: share (%) of the tile lookups of box reads that the
handle's tile cache served (the program's `op.region` spans, `hits` over
`tiles`)."""
from perfbench import program_spans as P

P.record()


def read(run):
    spans = [s for op in P.per_op(run) for s in op if s.name == "op.region" and "tiles" in s.attrs]
    tiles = sum(s.attrs["tiles"] for s in spans)
    return 100.0 * sum(s.attrs["hits"] for s in spans) / tiles if tiles else None
