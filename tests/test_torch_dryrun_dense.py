"""The dry run (``repro_torch.launch.dryrun``) over the dense decoder on a
fake 2x2 ("data", "model") mesh: granite-3-8b reduced, train, prefill and
decode cells, and the CLI and the roofline table on one reduced cell of
the production mesh (a fake process group of 256 ranks, one process).

Each cell completes with FLOPs above zero, the collectives its
placements need (FSDP's all-gathers and the gradients' reduce-scatters in
training, the flash-decode cache's all-reduces), and its static bytes
equal to ``sharded_bytes`` of its trees.  On the 2x2 mesh each device
counts a quarter of the one-device train cell's dot FLOPs, exactly
(tensor parallel on "model", data parallel on "data"); the reduced
prefill and decode batches (1 and 2 rows) split less evenly, so there a
device counts less than the whole, but more than a quarter of it.
"""
import contextlib

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import dryrun, roofline


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


@pytest.mark.parametrize("shape,kinds", [
    ("train_4k", {"all-gather", "reduce-scatter", "all-reduce"}),
    ("prefill_32k", {"all-gather", "all-reduce"}),
    ("decode_32k", {"all-gather", "all-reduce"}),
])
def test_granite_cells_trace_on_a_2x2_mesh(shape, kinds):
    with fake_mesh((1, 1)) as one:
        whole = dryrun.trace_cell("granite-3-8b", shape, False, reduced=True, mesh=one)
    with fake_mesh((2, 2)) as mesh:
        info = dryrun.trace_cell("granite-3-8b", shape, False, reduced=True, mesh=mesh)
    w = info["walked"]
    assert info["mesh"] == "2x2" and info["devices"] == 4 and info["mesh_device"] == "cpu"
    assert w["flops"] > 0 and kinds <= set(w["collectives"]), w["collectives"]
    assert w["wire_bytes"] > 0 and set(w["wire_bytes_by_mesh_dim"]) <= {"data", "model"}
    assert 0 < info["static_bytes_per_dev"] < whole["static_bytes_per_dev"]
    assert info["trace_s"] > 0 and info["ntokens"] > 0
    if shape == "train_4k":
        assert w["flops"] * 4 == whole["walked"]["flops"]
    else:
        assert whole["walked"]["flops"] / 4 < w["flops"] < whole["walked"]["flops"]


def test_cli_writes_a_cell_and_the_roofline_reads_it(tmp_path, capsys):
    out = tmp_path / "dr"
    rc = dryrun.main(["--arch", "granite-3-8b", "--shape", "prefill_32k", "--mesh", "single",
                      "--reduced", "--out", str(out)])
    assert rc == 0 and not dist.is_initialized()  # the cell's fake group is torn down
    rc = dryrun.main(["--arch", "granite-3-8b", "--shape", "long_500k", "--mesh", "single",
                      "--reduced", "--out", str(out)])
    assert rc == 0  # a skipped cell is no failure
    capsys.readouterr()
    roofline.main(["--dir", str(out), "--mesh", "all"])
    table = capsys.readouterr().out
    assert "| granite-3-8b | prefill_32k | 32x8 |" in table
    assert "long_500k / single: pure full attention" in table
