"""entropy_deflate_s.write: seconds a compress spends in the program's `entropy.deflate`
spans (each lane's zlib and framing)."""
from perfbench import program_spans as P

P.record()


def read(run):
    return P.seconds(run, "entropy.deflate")
