"""Port parity: the sharding rules (``repro_torch.launch.sharding``), the
dry run's ``sharded_bytes``, DTensor placements and ``reshard_restore``
against ``repro`` on the CPU.

The reference's ``param_pspecs``, ``opt_pspecs`` and ``cache_pspecs`` read
only a mesh's ``axis_names`` and ``devices.shape``, so a stand-in with
``devices=np.empty(shape)`` gives its specs on any mesh shape without the
devices.  Specs are compared leaf by leaf for equality (they are names,
not numbers: no tolerance); ``sharded_bytes`` exactly.  Placements and
restores run on a fake-backend process group (one process standing for
rank 0), torn down after each test.
"""
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from jax.sharding import PartitionSpec as RP

from repro import configs as RC
from repro.launch import sharding as RSH
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw as RA
from repro_torch import configs as PC
from repro_torch import tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as SH
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.runtime import reshard_restore

MESHES = {(1, 1): ("data", "model"), (2, 2): ("data", "model"), (16, 16): ("data", "model"),
          (32, 8): ("data", "model"), (2, 32, 8): ("pod", "data", "model")}
CACHE_B, CACHE_CTX = 4, 64


def _stand_in(shape):
    return types.SimpleNamespace(axis_names=MESHES[shape], devices=np.empty(shape))


def _ref_specs(spec_tree) -> list:
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        spec_tree, is_leaf=lambda s: isinstance(s, RP))]


def _port_specs(spec_tree) -> list:
    out = []

    def walk(t):
        if isinstance(t, SH.P):
            out.append(tuple(t))
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(spec_tree)
    return out


def _trees(arch, moments):
    """(reference, port) shape trees: parameters, AdamW state, decode cache."""
    rmodel, _ = RC.build_model(arch, reduced=True)
    rp = jax.eval_shape(lambda: rmodel.init(jax.random.PRNGKey(0)))
    ro = jax.eval_shape(lambda: RA.init(rp, RAdamWConfig(moment_dtype=moments)))
    rc = jax.eval_shape(lambda: rmodel.init_cache(CACHE_B, CACHE_CTX))
    pmodel, _ = PC.build_model(arch, reduced=True, device="cpu")
    pp = dryrun.abstract(lambda: pmodel.init(torch.Generator().manual_seed(0)))
    po = adamw.init(pp, AdamWConfig(moment_dtype=moments))
    meta_model = type(pmodel)(pmodel.cfg, device="meta")
    pc = meta_model.init_cache(CACHE_B, CACHE_CTX)
    return (rp, ro, rc), (pp, po, pc)


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_param_opt_and_cache_specs_are_the_references(arch):
    """Every leaf's spec, on every stand-in mesh, with FSDP on and off and
    each sequence axis; bf16 and int8 moments."""
    for moments in ("bf16", "int8"):
        (rp, ro, rc), (pp, po, pc) = _trees(arch, moments)
        for shape in MESHES:
            mesh = _stand_in(shape)
            for fsdp in (False, True):
                for seq_axis in (None, "model", "data"):
                    ropts = RSH.ShardingOptions(fsdp=fsdp, seq_axis=seq_axis)
                    popts = SH.ShardingOptions(fsdp=fsdp, seq_axis=seq_axis)
                    rps, pps = RSH.param_pspecs(rp, ropts, mesh), SH.param_pspecs(pp, popts, mesh)
                    assert _port_specs(pps) == _ref_specs(rps), (arch, shape, fsdp)
                    assert (_port_specs(SH.opt_pspecs(po, pps, popts, mesh))
                            == _ref_specs(RSH.opt_pspecs(ro, rps, ropts, mesh)))
                    assert (_port_specs(SH.cache_pspecs(pc, mesh, popts))
                            == _ref_specs(RSH.cache_pspecs(rc, mesh, ropts))), (arch, seq_axis)
                    assert tuple(SH.batch_pspec(mesh, seq_axis=seq_axis)) == tuple(
                        RSH.batch_pspec(mesh, seq_axis=seq_axis))


@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-v3-671b", "zamba2-1.2b",
                                  "whisper-small"])
def test_sharded_bytes_is_the_references(arch, monkeypatch):
    # importing the reference's dry run prepends its 512-device flag
    monkeypatch.setenv("XLA_FLAGS", "")
    from repro.launch import dryrun as RD

    (rp, ro, rc), (pp, po, pc) = _trees(arch, "int8")
    for shape in ((2, 2), (16, 16), (2, 32, 8)):
        mesh = _stand_in(shape)
        opts = dict(fsdp=True, seq_axis="model")
        rps = RSH.param_pspecs(rp, RSH.ShardingOptions(**opts), mesh)
        pps = SH.param_pspecs(pp, SH.ShardingOptions(**opts), mesh)
        assert dryrun.sharded_bytes(pp, pps, mesh) == RD.sharded_bytes(rp, rps, mesh)
        ros = RSH.opt_pspecs(ro, rps, RSH.ShardingOptions(**opts), mesh)
        pos = SH.opt_pspecs(po, pps, SH.ShardingOptions(**opts), mesh)
        for k in ("m", "v"):
            assert dryrun.sharded_bytes(po[k], pos[k], mesh) == RD.sharded_bytes(
                ro[k], ros[k], mesh)
        assert dryrun.sharded_bytes(pc, SH.cache_pspecs(pc, mesh, SH.ShardingOptions(**opts)),
                                    mesh) == RD.sharded_bytes(
            rc, RSH.cache_pspecs(rc, mesh, RSH.ShardingOptions(**opts)), mesh)


@pytest.mark.parametrize("base,shape,fsdp,want", [
    (("__fsdp__", "model"), (64, 48), True, ("data", "model")),   # both divide
    (("__fsdp__", "model"), (64, 48), False, (None, "model")),    # FSDP off
    (("__fsdp__", "model"), (63, 48), True, (None, "model")),     # data does not divide 63
    (("__fsdp__", "model"), (64, 50), True, ("data", None)),      # model does not divide 50
    (("model",), (3, 8), True, (None, "model")),                  # stacked: padded
    (("pod", "model"), (4, 8), True, (None, "model")),            # an axis the mesh lacks
])
def test_resolve_drops_axes_that_do_not_divide(base, shape, fsdp, want):
    sizes = {"data": 16, "model": 8}
    got = SH._resolve(base, shape, SH.ShardingOptions(fsdp=fsdp), sizes)
    ref = RSH._resolve(base, shape, RSH.ShardingOptions(fsdp=fsdp), sizes)
    assert tuple(got) == tuple(ref) == want


@pytest.fixture
def fake_mesh():
    """A (2, 2) ("data", "model") mesh over a fake 4-rank process group."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_named_gives_the_placements_the_specs_mean(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard

    R, S = Replicate(), Shard
    specs = {"a": SH.P("data", "model"), "b": SH.P(None, "data"), "c": SH.P(),
             "d": SH.P(("data", "model"), None), "e": SH.P("model", None, "data")}
    want = {"a": (S(0), S(1)), "b": (S(1), R), "c": (R, R), "d": (S(0), S(0)),
            "e": (S(2), S(0))}
    assert SH.named(fake_mesh, specs) == want
    with pytest.raises(ValueError):  # minor axis before the major one
        SH.placements(fake_mesh, SH.P(("model", "data")))
    g = torch.Generator().manual_seed(0)
    shapes = {"a": (8, 6), "b": (3, 8), "c": (5,), "d": (8, 3), "e": (4, 3, 6)}
    tensors = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    placed = SH.distribute(tensors, fake_mesh, specs)
    local = {"a": (4, 3), "b": (3, 4), "c": (5,), "d": (2, 3), "e": (2, 3, 3)}
    for k, t in placed.items():
        assert tuple(t.shape) == shapes[k] and tuple(t.to_local().shape) == local[k]
        assert t.placements == want[k]
    # rank 0's shard is the leading block of every sharded dim
    assert torch.equal(placed["a"].to_local(), tensors["a"][:4, :3])
    assert torch.equal(placed["e"].to_local(), tensors["e"][:2, :, :3])


def test_reshard_restore_places_by_the_specs_and_keeps_the_values(fake_mesh, tmp_path):
    from torch.distributed.tensor import DTensor

    pmodel, _ = PC.build_model("granite-3-8b", reduced=True, device="cpu")
    params = pmodel.init(torch.Generator().manual_seed(1))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, params)
    target = tree.rebuild(params, lambda _, t: torch.zeros_like(t))
    opts = SH.ShardingOptions(fsdp=True)
    back = reshard_restore(mgr, target, fake_mesh, opts=opts)
    specs = SH.param_pspecs(target, opts, fake_mesh)
    placements = SH.named(fake_mesh, specs)
    for (path, got), (_, want) in zip(tree.leaves(back), tree.leaves(params)):
        assert isinstance(got, DTensor) and got.placements == tree.get(placements, path)
        assert got.dtype == want.dtype and tuple(got.shape) == tuple(want.shape)
        # rank 0's shard holds the saved values of its block
        local = got.to_local()
        assert torch.equal(local, want[tuple(slice(0, n) for n in local.shape)])
    assert any(SH.P() != s for s in _port_specs(specs))  # something was sharded
    # on a device, as before
    plain = reshard_restore(mgr, target, "cpu")
    for (_, got), (_, want) in zip(tree.leaves(plain), tree.leaves(params)):
        assert torch.equal(got, want)


def test_new_launch_modules_import_without_jax(tmp_path):
    """The dry run's modules (and ``dryrun_h100.py``) import neither jax nor
    the reference, in a fresh interpreter where both are blocked."""
    import ast
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    tree_ = ast.parse((root / "dryrun_h100.py").read_text())
    mods = [a.name for n in ast.walk(tree_) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree_) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import repro_torch.launch.mesh, repro_torch.launch.sharding\n"
            "import repro_torch.launch.shapes, repro_torch.launch.steps\n"
            "import repro_torch.launch.opcount, repro_torch.launch.dryrun\n"
            "import repro_torch.launch.roofline, repro_torch.models.spmd\n"
            "import repro_torch.runtime.elastic, repro_torch.data.tokens\n"
            "import torch.distributed as dist; assert not dist.is_initialized()\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
