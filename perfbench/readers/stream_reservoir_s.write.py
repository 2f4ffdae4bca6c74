"""stream_reservoir_s.write: seconds a streamed compress spends in the
program's `stream.reservoir` spans (the batch's reconstruction copied back,
the residual on the host, Algorithm R)."""
from perfbench import program_spans as P

P.record()


def read(run):
    return P.seconds(run, "stream.reservoir")
