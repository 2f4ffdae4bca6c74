"""lane_tables_s.read: seconds a decode spends in the program's `lane.tables` spans
(codec cache lookups; on a miss the table parse and its decode tables on the device)."""
from perfbench import program_spans as P

P.record()


def read(run):
    return P.seconds(run, "lane.tables")
