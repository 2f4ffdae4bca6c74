"""lane_inflate_s.read: seconds a decode spends in the program's `lane.inflate` spans
(zlib inflate of each lane)."""
from perfbench import program_spans as P

P.record()


def read(run):
    return P.seconds(run, "lane.inflate")
