"""deflate_pool_share: share (%) of a compress's `entropy.deflate` spans in which the
program's pool of host threads took the lanes' zlib (the span's `pooled` attribute)."""
from perfbench import program_spans as P

P.record()


def read(run):
    return P.share_pct(run, "entropy.deflate", "pooled")
