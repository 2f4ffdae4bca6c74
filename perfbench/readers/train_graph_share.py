"""train_graph_share: share (%) of a compress's `train.step` spans that replayed the
program's captured training step (the span's `graph` attribute)."""
from perfbench import program_spans as P

P.record()


def read(run):
    return P.share_pct(run, "train.step", "graph")
