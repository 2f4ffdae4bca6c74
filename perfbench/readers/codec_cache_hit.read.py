"""codec_cache_hit.read: share (%) of a decode's `lane.tables` spans that found the
lane's codec in the program's cache."""
from perfbench import program_spans as P

P.record()


def read(run):
    return P.share_pct(run, "lane.tables", "hit")
