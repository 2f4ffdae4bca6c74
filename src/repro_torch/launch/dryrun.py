"""The multi-node dry run, port of ``repro/launch/dryrun.py``:
``python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--mesh
single|multi|both] [--reduced] [--set k=v ...] [--tag T] [--out DIR]``.

For every (arch x shape x mesh) cell it builds the parameters, optimizer
state, cache and batch as shape-only (``meta``) tensors, places them as
DTensors by the sharding rules on the production H100 mesh (a fake
process group of 256 or 512 ranks: ``launch/mesh.py``), and runs one
train, prefill or decode step under :class:`~repro_torch.launch.opcount.
OpCounter`.  No byte is allocated and no kernel runs: what comes out is
one device's dot FLOPs, collectives and wire bytes (``walked``), the
static bytes a device holds under the specs, and the time the trace took
(``trace_s``, in place of the reference's ``lower_s`` and
``compile_s``).  One JSON per cell goes to ``--out``; a cell that fails
is written as an error row and the CLI exits 1.

XLA's ``cost_analysis`` and ``memory_analysis`` and the ``.hlo.z``
sidecar have no counterpart in eager PyTorch: nothing here stands in for
them.  On a CPU mesh DTensor has no all-to-all and redistributes through
an all-gather instead, so a row traced without a card records
``mesh_device: "cpu"`` and counts those as all-gathers.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config, get_family
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import batch_axes_of, make_production_mesh
from repro_torch.launch.opcount import OpCounter
from repro_torch.launch.shapes import SHAPES, cell_applicable, cell_specs, input_specs
from repro_torch.launch.steps import (TrainOptions, make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.decoder import DecoderLM
from repro_torch.models.encdec import EncDecLM
from repro_torch.optim import adamw

# Per-arch training settings of the reference (chosen there for its memory
# envelope), not retuned; --set overrides them.
ARCH_TRAIN_DEFAULTS: dict[str, dict] = {
    "llama3-405b": dict(fsdp=True, microbatch=16, moment_dtype="bf16"),
    "deepseek-v3-671b": dict(fsdp=True, microbatch=16, moment_dtype="int8"),
    "llama4-scout-17b-a16e": dict(fsdp=True, microbatch=4, moment_dtype="bf16"),
    "granite-3-8b": dict(fsdp=True, microbatch=1),
    "yi-9b": dict(fsdp=True, microbatch=1),
    "qwen2-vl-7b": dict(fsdp=True, microbatch=1),
    "rwkv6-7b": dict(fsdp=True, microbatch=1),
}
# decode cells: sequence-shard global KV caches over "model" (flash-decode);
# long_500k batch=1 shards sequence over "data" too.
ARCH_DECODE_SEQ_AXIS = {"decode_32k": "model", "long_500k": "data"}


def count_params(tensors) -> int:
    return sum(t.numel() for _, t in tree.leaves(tensors))


def active_param_fraction(cfg) -> float:
    """MoE: fraction of routed-expert params active per token."""
    if cfg.moe is None:
        return 1.0
    return cfg.moe.top_k / cfg.moe.n_experts


def sharded_bytes(tensors, spec_tree, mesh) -> int:
    """Static per-device bytes given the sharding specs."""
    sizes = SH.axis_sizes(mesh)

    def one(path, leaf) -> int:
        b = leaf.numel() * leaf.element_size()
        denom = 1
        for ax in tree.get(spec_tree, path):
            for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
                denom *= sizes.get(a, 1)
        return b // max(denom, 1)

    return sum(one(path, leaf) for path, leaf in tree.leaves(tensors))


def abstract(fn):
    """``fn()``'s tensors as ``meta`` tensors of the same shapes and dtypes,
    run under ``FakeTensorMode`` (no storage, no arithmetic): the
    reference's ``jax.eval_shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        out = fn()

    def meta(_, t):
        if not isinstance(t, torch.Tensor):
            return t
        return torch.empty(t.shape, dtype=t.dtype, device="meta").requires_grad_(t.requires_grad)

    return tree.rebuild(out, meta)


def mesh_label(mesh) -> str:
    return "x".join(str(s) for s in mesh.mesh.shape)


def _walk(oc: OpCounter, info: dict, mesh) -> dict:
    walked = oc.summary()
    info["collectives"] = walked["collectives"]
    info["wire_bytes_per_dev"] = walked["wire_bytes"]
    info["walked"] = walked
    info["mesh_device"] = mesh.device_type
    return info


def trace_gwlz_cell(multi_pod: bool, *, overrides: dict | None = None, mesh=None) -> dict:
    """The paper's own technique on the production mesh: group-wise
    enhancer training over a 512^3 Nyx volume (groups -> model, slices ->
    data), one step of ``launch/gwlz_dist.py``'s per-device program.  Its
    ``group_hist`` launch runs the kernel's shape rule only (a custom op's
    fake implementation), counted under ``walked["kernels"]``."""
    from repro_torch.launch import gwlz_dist as GD

    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    kw = dict(grad_compress=False)
    if overrides:
        kw.update({k: v for k, v in overrides.items()
                   if k in ("grad_compress", "n_groups", "batch_slices")})
    dcfg = GD.DistGWLZConfig(**kw)
    t0 = time.perf_counter()
    state = abstract(lambda: GD.build_state(dcfg, generator=torch.Generator(), device="cpu"))
    s_specs = GD.state_pspecs(dcfg, state)
    batch = GD.input_specs(dcfg)
    b_specs = GD.batch_pspecs(mesh)
    step = GD.make_dist_train_step(dcfg, device="meta", mesh=mesh)
    placed = SH.distribute(state, mesh, s_specs)
    with OpCounter(mesh) as oc:
        step(placed, SH.distribute(batch, mesh, b_specs))
    info = {
        "arch": "gwlz-nyx", "shape": "vol512_g32", "mesh": mesh_label(mesh),
        "devices": mesh.size(), "settings": kw,
        "n_params": count_params(state["params"]), "active_fraction": 1.0,
        "trace_s": time.perf_counter() - t0,
        "ntokens": dcfg.batch_slices * dcfg.volume * dcfg.volume,  # voxels a step
        # the reference writes 0 here; the port counts the state's shards
        "static_bytes_per_dev": sum(
            sharded_bytes(state[k], s_specs[k], mesh) for k in ("params", "bn")) + sum(
            sharded_bytes(state["opt"][k], s_specs["opt"][k], mesh) for k in ("m", "v")),
    }
    return _walk(oc, info, mesh)


def trace_cell(arch: str, shape: str, multi_pod: bool, *, overrides: dict | None = None,
               reduced: bool = False, mesh=None, cfg=None, cell=None) -> dict:
    """One (arch x shape) cell on the production mesh (or on ``mesh``).
    ``cfg`` (a ``ModelConfig``) and ``cell`` (a ``ShapeCell``) replace the
    arch's config and the named shape, to trace a cut-down cell."""
    if arch == "gwlz-nyx":
        return trace_gwlz_cell(multi_pod, overrides=overrides, mesh=mesh)
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    baxes = batch_axes_of(mesh)
    if cell is None:
        spec = input_specs(arch, shape, reduced=reduced)
        spec["cfg"] = spec["cfg"] if cfg is None else cfg
    else:
        spec = cell_specs(cfg if cfg is not None else get_config(arch, reduced=reduced),
                          get_family(arch), cell, cell.global_batch, cell.seq_len)
    cfg, cell = spec["cfg"], spec["cell"]
    cls = EncDecLM if get_family(arch) == "encdec" else DecoderLM
    init_model, model = cls(cfg, device="cpu"), cls(cfg, device="meta")

    t0 = time.perf_counter()
    params = abstract(lambda: init_model.init(torch.Generator().manual_seed(0)))
    train_kw = dict(ARCH_TRAIN_DEFAULTS.get(arch, {}))
    if overrides:
        train_kw.update({k: v for k, v in overrides.items()
                         if k in ("fsdp", "microbatch", "moment_dtype")})
    seq_axis = ARCH_DECODE_SEQ_AXIS.get(shape)
    if overrides and "seq_axis" in overrides:
        seq_axis = overrides["seq_axis"]
    sizes = SH.axis_sizes(mesh)
    n_b = 1
    for a in baxes:
        n_b *= sizes[a]
    B = next(iter(spec["batch"].values())).shape[0]
    rows = B // n_b if B % n_b == 0 else B  # a rank's batch rows
    if cell.kind == "train" and train_kw.get("microbatch", 1) > rows:
        # a microbatch spans every data shard, at least a row on each: the
        # reference's 16 on 16 data shards is 8 on 32
        train_kw["microbatch_cut_from"] = train_kw["microbatch"]
        train_kw["microbatch"] = rows
    sh_opts = SH.ShardingOptions(fsdp=bool(train_kw.get("fsdp", False)), seq_axis=seq_axis)
    pspecs = SH.param_pspecs(params, sh_opts, mesh)
    p = SH.distribute(params, mesh, pspecs)

    def bspec(leaf) -> SH.P:
        if leaf.ndim == 0 or leaf.shape[0] % n_b != 0:
            return SH.P(*([None] * leaf.ndim))
        return SH.P(baxes, *([None] * (leaf.ndim - 1)))

    batch = spec["batch"]
    b = SH.distribute(batch, mesh, {k: bspec(v) for k, v in batch.items()})
    info: dict = {
        "arch": arch, "shape": cell.name, "mesh": mesh_label(mesh), "devices": mesh.size(),
        "settings": {**train_kw, "seq_axis": seq_axis},
        "n_params": count_params(params), "active_fraction": active_param_fraction(cfg),
    }
    if cfg.moe is not None:
        info["moe_dispatch"] = ("each data shard routes its own tokens into its own [E, cap] "
                                "buffer (capacity per shard); experts sharded on model, their "
                                "outputs all-gathered over model: no all-to-all")
    oc = OpCounter(mesh)
    if cell.kind == "train":
        opts = TrainOptions(**{k: v for k, v in train_kw.items()
                               if k in ("moment_dtype", "fsdp", "microbatch")})
        gp = pspecs if (overrides or {}).get("grad_rs") else None
        step, adam_cfg = make_train_step(model, cfg, opts, mesh, grad_pspecs=gp)
        opt = adamw.init(params, adam_cfg)
        o_specs = SH.opt_pspecs(opt, pspecs, sh_opts, mesh)
        o = SH.distribute(opt, mesh, o_specs)
        with oc:
            step(p, o, b, None)
        info["static_bytes_per_dev"] = (
            sharded_bytes(params, pspecs, mesh) + sharded_bytes(opt["m"], o_specs["m"], mesh)
            + sharded_bytes(opt["v"], o_specs["v"], mesh))
        ntokens = cell.global_batch * cell.seq_len
    elif cell.kind == "prefill":
        step = make_prefill_step(model, cfg, mesh)
        with oc:
            step(p, b)
        info["static_bytes_per_dev"] = sharded_bytes(params, pspecs, mesh)
        ntokens = cell.global_batch * cell.seq_len
    else:  # decode
        cache = model.init_cache(B, spec["ctx"])
        c_specs = SH.cache_pspecs(cache, mesh, sh_opts)
        c = SH.distribute(cache, mesh, c_specs)
        step = make_decode_step(model, mesh)
        with oc:
            step(p, c, b)
        info["static_bytes_per_dev"] = (sharded_bytes(params, pspecs, mesh)
                                        + sharded_bytes(cache, c_specs, mesh))
        ntokens = cell.global_batch  # one token per sequence
    info["trace_s"] = time.perf_counter() - t0
    info["ntokens"] = ntokens
    return _walk(oc, info, mesh)


def _parse_set(pairs) -> dict:
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        overrides[k] = {"true": True, "false": False}.get(v.lower(), v)
        if isinstance(overrides[k], str) and overrides[k].isdigit():
            overrides[k] = int(overrides[k])
    return overrides


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description="multi-node dry run: trace every cell")
    ap.add_argument("--arch", default="all", help="arch id, gwlz-nyx or 'all'")
    ap.add_argument("--shape", default="all", help="shape cell or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--reduced", action="store_true", help="reduced configs (CI smoke)")
    ap.add_argument("--set", nargs="*", default=[],
                    help="override k=v (fsdp/microbatch/moment_dtype/seq_axis/grad_rs)")
    ap.add_argument("--tag", default="", help="suffix for output files (perf experiments)")
    args = ap.parse_args(argv)
    overrides = _parse_set(args.set)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    if args.arch == "gwlz-nyx":
        shapes = ["vol512_g32"]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            ok, why = (True, "") if arch == "gwlz-nyx" else cell_applicable(arch, shape)
            for multi in meshes:
                mesh_tag = "multi" if multi else "single"
                name = f"{arch}_{shape}_{mesh_tag}{args.tag}"
                path = os.path.join(args.out, name + ".json")
                if not ok:
                    _dump(path, {"arch": arch, "shape": shape, "mesh": mesh_tag, "skipped": why})
                    print(f"SKIP {name}: {why}", flush=True)
                    continue
                if os.path.exists(path) and not overrides and not args.tag:
                    print(f"CACHED {name}", flush=True)
                    continue
                try:
                    info = trace_cell(arch, shape, multi, overrides=overrides,
                                      reduced=args.reduced)
                    _dump(path, info)
                    print(f"OK {name}: trace={info['trace_s']:.2f}s "
                          f"flops={info['walked']['flops']:.3g} "
                          f"static={info['static_bytes_per_dev'] / 2**30:.2f}GiB "
                          f"wire={info['wire_bytes_per_dev'] / 2**30:.3f}GiB", flush=True)
                except Exception as e:
                    failures += 1
                    _dump(path, {"arch": arch, "shape": shape, "mesh": mesh_tag,
                                 "error": f"{type(e).__name__}: {e}",
                                 "traceback": traceback.format_exc()})
                    print(f"FAIL {name}: {type(e).__name__}: {e}", flush=True)
                finally:
                    _end_world()
    print(f"done; failures={failures}")
    return 1 if failures else 0


def _dump(path: str, obj: dict) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def _end_world() -> None:
    """Destroys the fake process group a cell set up (the next cell's mesh
    may have another size)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
