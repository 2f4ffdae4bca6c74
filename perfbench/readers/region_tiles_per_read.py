"""region_tiles_per_read: tiles a box read touches (the program's `op.region`
spans, `tiles`), over the reads after op 0."""
import numpy as np

from perfbench import program_spans as P

P.record()


def read(run):
    got = [s.attrs["tiles"] for op in P.per_op(run) for s in op
           if s.name == "op.region" and "tiles" in s.attrs]
    return float(np.mean(got)) if got else None
