"""gwlz-nyx: the paper's own workload for the distributed GWLZ trainer,
port of ``repro/configs/gwlz_nyx.py`` (``:12-17``).

512^3 Nyx field, 32 enhancer groups (the paper uses 20; the reference pads
to a multiple of its model axis), a global batch of 512 slices.
"""
from repro_torch.launch.gwlz_dist import DistGWLZConfig

FAMILY = "gwlz"
LONG_CONTEXT_OK = False


def get_config(reduced: bool = False) -> DistGWLZConfig:
    if reduced:
        return DistGWLZConfig(n_groups=4, volume=32, batch_slices=8)
    return DistGWLZConfig(n_groups=32, volume=512, batch_slices=512)
