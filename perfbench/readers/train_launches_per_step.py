"""train_launches_per_step: CUDA launch and copy calls a training step issues, in the
profiled compress (the runtime calls inside the program's `train.step` spans)."""
from perfbench import program_spans as P

P.record()


def read(run):
    return P.launches_per_span(run, "train.step")
