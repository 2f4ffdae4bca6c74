"""entropy_fit_s.write: seconds a compress spends in the program's `entropy.fit` spans
(lane minima copied back, lane histograms, Huffman trees, table upload)."""
from perfbench import program_spans as P

P.record()


def read(run):
    return P.seconds(run, "entropy.fit")
