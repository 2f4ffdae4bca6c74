"""lane_decode_s.read: seconds a decode spends in the program's `lane.decode` spans
(each lane's stream upload, chunk offsets and decode launch)."""
from perfbench import program_spans as P

P.record()


def read(run):
    return P.seconds(run, "lane.decode")
