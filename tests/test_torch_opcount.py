"""The dry run's op counter (``repro_torch.launch.opcount``, the counterpart
of ``repro/launch/hlowalk.py``) and roofline (``launch/roofline.py``) on
the CPU.

* FLOPs on a one-device mesh against ``hlowalk.walk`` of the reference's
  compiled step (its 1-device host, no mesh) for reduced train, prefill
  and decode cells: equal for the dense decoder, MoE (llama4) and the
  encoder-decoder (whisper), to the FLOP.  rwkv6's train cell differs by
  one dot, exactly: its WKV step reads the state with
  ``einsum("bhk,bhkv->bhv")`` (2·B·H·hd² FLOPs a step), and the
  reference's backward scan recomputes that read once more a step than
  the port's autograd does (5 such dots a step and layer against 4), so
  the port counts 2·B·H·hd²·T·L fewer (1,048,576 of 248,512,512).
* On a fake 2x2 mesh a sharded product is counted at one device's share,
  and each collective at its mesh dim.
* The ring formulas give the reference's ``wire_bytes`` on the same
  collective lists; ``roofline.analyse`` equals a hand computation on a
  fixed cell.
"""
import math

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro import configs as RC
from repro.launch import hlowalk
from repro.launch import shapes as RSHAPES
from repro.launch import steps as RS
from repro.optim import adamw as RA
from repro_torch.launch import dryrun, opcount, roofline
from repro_torch.launch import sharding as SH
from repro_torch.models.spmd import einsum


@pytest.fixture
def fake_mesh(request):
    """A ("data", "model") mesh of the parametrized shape over a fake
    process group, torn down after the test."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = getattr(request, "param", (1, 1))
    n = shape[0] * shape[1]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _ref_flops(arch: str, shape: str) -> float:
    """hlowalk's FLOPs of the reference's jitted step at the dry run's
    settings (reduced; the microbatch cut to the batch, as the port's)."""
    rm, _ = RC.build_model(arch, reduced=True)
    spec = RSHAPES.input_specs(arch, shape, reduced=True)
    cfg, cell, batch = spec["cfg"], spec["cell"], spec["batch"]
    ps = jax.eval_shape(lambda: rm.init(jax.random.PRNGKey(0)))
    if cell.kind == "train":
        kw = dict(dryrun.ARCH_TRAIN_DEFAULTS.get(arch, {}))
        kw["microbatch"] = min(kw.get("microbatch", 1), next(iter(batch.values())).shape[0])
        step, adam_cfg = RS.make_train_step(rm, cfg, RS.TrainOptions(**kw), mesh=None)
        opt = jax.eval_shape(lambda: RA.init(ps, adam_cfg))
        lowered = jax.jit(step).lower(ps, opt, batch, jax.ShapeDtypeStruct((2,), jnp.uint32))
    elif cell.kind == "prefill":
        lowered = jax.jit(RS.make_prefill_step(rm, cfg)).lower(ps, batch)
    else:
        cache = jax.eval_shape(lambda: rm.init_cache(batch["token"].shape[0], spec["ctx"]))
        lowered = jax.jit(RS.make_decode_step(rm, cfg)).lower(ps, cache, batch)
    return hlowalk.walk(lowered.compile().as_text())["flops"]


@pytest.mark.parametrize("arch,shape", [
    ("granite-3-8b", "train_4k"), ("granite-3-8b", "prefill_32k"),
    ("granite-3-8b", "decode_32k"), ("llama4-scout-17b-a16e", "train_4k"),
    ("whisper-small", "train_4k"), ("rwkv6-7b", "train_4k")])
def test_flops_on_one_device_match_hlowalk(arch, shape, fake_mesh):
    info = dryrun.trace_cell(arch, shape, False, reduced=True, mesh=fake_mesh)
    got, want = info["walked"]["flops"], _ref_flops(arch, shape)
    assert info["walked"]["wire_bytes"] == 0.0 and info["devices"] == 1
    if arch == "rwkv6-7b":  # one recompute of the WKV state read (the module docstring)
        cfg = RC.get_config(arch, reduced=True)
        B, T = RSHAPES.input_specs(arch, shape, reduced=True)["batch"]["tokens"].shape
        r = cfg.rwkv
        assert want - got == 2 * B * r.n_heads * r.head_dim ** 2 * T * cfg.n_layers
    else:
        assert got == want


@pytest.mark.parametrize("fake_mesh", [(2, 2)], indirect=True)
def test_a_sharded_product_is_counted_at_one_devices_share(fake_mesh):
    from torch.distributed.tensor import distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    mesh = fake_mesh
    x = distribute_tensor(torch.randn(8, 16), mesh, SH.placements(mesh, SH.P("data", None)),
                          src_data_rank=None)
    w = distribute_tensor(torch.randn(16, 32), mesh, SH.placements(mesh, SH.P(None, "model")),
                          src_data_rank=None)
    with opcount.OpCounter(mesh) as oc:
        y = einsum("bd,df->bf", x, w)
    assert oc.flops == 2 * (8 // 2) * (32 // 2) * 16 and not oc.collectives
    with FlopCounterMode(display=False) as fc:  # PyTorch's counter sees the global product
        torch.einsum("bd,df->bf", x, w)
    assert fc.get_total_flops() == 4 * oc.flops
    # a contraction split on "model" leaves a partial sum: one all-reduce there
    v = distribute_tensor(torch.randn(32, 4), mesh, SH.placements(mesh, SH.P("model", None)),
                          src_data_rank=None)
    with opcount.OpCounter(mesh) as oc:
        z = einsum("bf,fo->bo", y, v)
        z.full_tensor()
    kinds = {(c["kind"], c["mesh_dim"]) for c in oc.collectives}
    assert ("all-reduce", "model") in kinds
    assert oc.flops == 2 * (8 // 2) * 4 * (32 // 2)


def test_wire_bytes_are_the_references(monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", "")  # the reference's dry run prepends its device flag
    from repro.launch import dryrun as RD

    colls = [{"kind": k, "bytes": b, "group": g}
             for k in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                       "collective-permute")
             for b, g in ((4096, 8), (1 << 20, 32), (12, 1), (3, 2))]
    for i in range(len(colls)):
        assert opcount.wire_bytes(colls[:i + 1]) == RD.wire_bytes(colls[:i + 1])


def test_roofline_analyse_is_the_hand_computation():
    cell = {"arch": "granite-3-8b", "shape": "train_4k", "mesh": "32x8", "devices": 256,
            "n_params": 8_000_000_000, "active_fraction": 1.0, "ntokens": 1_048_576,
            "static_bytes_per_dev": 40e9, "trace_s": 12.5,
            "walked": {"flops": 2.0e14, "wire_bytes_by_mesh_dim": {"model": 9e9, "data": 1e9}}}
    r = roofline.analyse(cell)
    t_comp, t_mem = 2.0e14 / 989e12, 5 * 40e9 / 3.35e12
    t_coll = 9e9 / 450e9 + 1e9 / 50e9
    assert r["t_compute_s"] == pytest.approx(t_comp, rel=1e-12)
    assert r["t_memory_s"] == pytest.approx(t_mem, rel=1e-12)
    assert r["t_collective_s"] == pytest.approx(t_coll, rel=1e-12)
    mf = 6 * 8e9 * 1_048_576
    assert r["dominant"] == max({"compute": t_comp, "memory": t_mem, "collective": t_coll}.items(),
                                key=lambda kv: kv[1])[0]
    assert r["useful_fraction"] == pytest.approx(mf / 256 / 2.0e14, rel=1e-12)
    assert r["roofline_fraction"] == pytest.approx(
        mf / 256 / 989e12 / max(t_comp, t_mem, t_coll), rel=1e-12)
    assert r["fits_80GB"] == (40e9 < 0.875 * roofline.DEVICE_MEMORY) and r["static_GB"] == 40.0
    assert roofline.analyse({**cell, "error": "x"}) is None
    assert math.isclose(roofline.model_flops({**cell, "shape": "decode_32k"}),
                        2 * 8e9 * 1_048_576)
    table = roofline.markdown_table([r])
    assert "| granite-3-8b | train_4k | 32x8 |" in table and "**" + r["dominant"] + "**" in table
