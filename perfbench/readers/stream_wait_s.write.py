"""stream_wait_s.write: seconds a streamed compress spends in the program's
`stream.wait` spans (the caller blocked on the host stage: the previous
batch's append, commit and fsync)."""
from perfbench import program_spans as P

P.record()


def read(run):
    return P.seconds(run, "stream.wait")
