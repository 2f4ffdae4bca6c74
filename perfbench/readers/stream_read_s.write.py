"""stream_read_s.write: seconds a streamed compress spends in the program's
`stream.read` and `stream.h2d` spans (each batch's tiles read from the host
array, then copied to the card)."""
from perfbench import program_spans as P

P.record()


def read(run):
    got = [P.seconds(run, name) for name in ("stream.read", "stream.h2d")]
    return None if got == [None, None] else sum(s or 0.0 for s in got)
