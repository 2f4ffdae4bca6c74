"""region_enhance_s: seconds a box read spends in the program's
`gwlz.enhance_tiles` spans (`group_hist` and `enhancer_fused` on the tiles
it decoded)."""
from perfbench import program_spans as P

P.record()


def read(run):
    return P.seconds(run, "gwlz.enhance_tiles")
