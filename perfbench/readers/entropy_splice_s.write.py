"""entropy_splice_s.write: seconds a compress spends in the program's `entropy.splice`
spans (each lane's packed chunks joined into one bit stream on the host)."""
from perfbench import program_spans as P

P.record()


def read(run):
    return P.seconds(run, "entropy.splice")
