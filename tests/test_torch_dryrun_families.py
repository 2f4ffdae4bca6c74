"""The dry run (``repro_torch.launch.dryrun``) over the other families on
a fake 2x2 ("data", "model") mesh: the reduced train cells of llama4-scout
(MoE), deepseek-v3 (MLA and MoE, int8 moments) and whisper (the
encoder-decoder).  Each completes with FLOPs above zero, the collectives
its placements need (FSDP's all-gathers, the gradients' reductions),
static bytes above zero, and the microbatch cut to a rank's rows where
the reduced batch has fewer (the settings record the cut).
"""
import contextlib

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import dryrun


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


@pytest.mark.parametrize("arch,microbatch", [("llama4-scout-17b-a16e", (4, 2)),
                                             ("deepseek-v3-671b", (16, 2)),
                                             ("whisper-small", (None, 1))])
def test_train_cells_trace_on_a_2x2_mesh(arch, microbatch):
    with fake_mesh((2, 2)) as mesh:
        info = dryrun.trace_cell(arch, "train_4k", False, reduced=True, mesh=mesh)
    w = info["walked"]
    assert w["flops"] > 0 and info["static_bytes_per_dev"] > 0
    assert {"all-gather", "all-reduce"} <= set(w["collectives"]), w["collectives"]
    cut_from, m = microbatch
    assert info["settings"].get("microbatch", 1) == m
    assert info["settings"].get("microbatch_cut_from") == cut_from
    assert ("moe_dispatch" in info) == (arch != "whisper-small")
    assert 0 < info["active_fraction"] <= 1.0 and info["n_params"] > 0
