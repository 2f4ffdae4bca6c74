"""The dry run (``repro_torch.launch.dryrun``) over the recurrent and
hybrid families and GWLZ on a fake 2x2 ("data", "model") mesh: the
reduced train cells of rwkv6-7b and zamba2-1.2b (Python loops over T
under DTensor dispatch, so cut to 16 positions: the loop is the trace's
time) and the gwlz-nyx cell (the distributed GWLZ step
at a cut batch: 4 groups, 4 slices of 512^2).  Each completes with FLOPs
above zero and the collectives its placements need; gwlz-nyx's step
launches ``group_hist`` once through its shape rule (no kernel, no plain
version ran) and reduces over "data" only (groups are independent).
"""
import contextlib

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import dryrun
from repro_torch.launch.shapes import ShapeCell


@contextlib.contextmanager
def fake_mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = shape[0] * shape[1]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b"])
def test_recurrent_train_cells_trace_on_a_2x2_mesh(arch):
    with fake_mesh((2, 2)) as mesh:
        info = dryrun.trace_cell(arch, "train_4k", False, reduced=True, mesh=mesh,
                                 cell=ShapeCell("train_4k", 16, 4, "train"))
    w = info["walked"]
    assert info["ntokens"] == 4 * 16
    assert w["flops"] > 0 and {"all-gather", "all-reduce"} <= set(w["collectives"])
    assert info["static_bytes_per_dev"] > 0 and info["trace_s"] > 0


def test_gwlz_cell_traces_on_a_2x2_mesh():
    with fake_mesh((2, 2)) as mesh:
        info = dryrun.trace_cell("gwlz-nyx", "vol512_g32", False, mesh=mesh,
                                 overrides={"n_groups": 4, "batch_slices": 4})
    w = info["walked"]
    assert info["arch"] == "gwlz-nyx" and info["settings"]["n_groups"] == 4
    assert w["kernels"] == {"group_hist": {"launches": 1, "elements": 2 * 512 * 512 + 5}}
    assert w["flops"] > 0 and set(w["collectives"]) == {"all-reduce"}
    assert set(w["wire_bytes_by_mesh_dim"]) == {"data"}  # groups never meet
    assert info["ntokens"] == 4 * 512 * 512 and info["static_bytes_per_dev"] > 0
