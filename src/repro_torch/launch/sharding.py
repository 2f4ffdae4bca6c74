"""Parameter, optimizer, batch and cache sharding rules, port of
``repro/launch/sharding.py`` (``:1-142``, ``:199-240``).

Rules are keyed by a parameter's leaf name (the last dict key on its tree
path) and give the spec of the *base* (unstacked) tensor; leading
layer-stacking axes are padded with None.  ``FSDP`` is a placeholder that
resolves to the data axis when ZeRO-3-style parameter sharding is on (the
405B/671B training cells), else to None.  A spec names a mesh axis (or a
tuple of them, or None) per tensor dim, as JAX's ``PartitionSpec`` does;
:func:`named` turns it into DTensor placements on a ``DeviceMesh`` and
:func:`distribute` places a tree by it.

``tile_mesh``, ``map_tiles`` and ``device_round`` (the reference's
``:145-196``) are not ported: the port's tile paths run on one card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import tree
from repro_torch.launch.mesh import batch_axes_of

FSDP = "__fsdp__"
MODEL = "model"


class P(tuple):
    """A partition spec: per tensor dim, a mesh-axis name, a tuple of them
    (major first), or None (unsharded).  ``P()`` is fully replicated.  A
    tuple of one axis is that axis, as JAX's ``PartitionSpec`` keeps it."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and len(a) == 1 else a
                                     for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# leaf name -> base spec (tail-aligned to the leaf's trailing dims)
PARAM_RULES: dict[str, tuple] = {
    # embeddings / heads
    "embed": (MODEL, FSDP),         # [V, d] vocab-sharded
    "lm_head": (FSDP, MODEL),       # [d, V]
    "pos_dec": (None, FSDP),
    # attention (GQA)
    "wq": (FSDP, MODEL, None),      # [d, H, hd]
    "wk": (FSDP, MODEL, None),
    "wv": (FSDP, MODEL, None),
    "wo": (MODEL, None, FSDP),      # [H, hd, d]
    "q_norm": (None,),
    "k_norm": (None,),
    # MLA
    "w_dq": (FSDP, None),
    "w_uq": (None, MODEL, None),
    "w_dkv": (FSDP, None),
    "w_kr": (FSDP, None),
    "w_uk": (None, MODEL, None),
    "w_uv": (None, MODEL, None),
    "q_ln": (None,),
    "kv_ln": (None,),
    # dense mlp
    "w_up": (FSDP, MODEL),          # [d, F]
    "w_gate": (FSDP, MODEL),
    "w_down": (MODEL, FSDP),        # [F, d]
    # moe
    "router": (None, None),
    # rwkv6
    "wr": (FSDP, MODEL),
    "wg": (FSDP, MODEL),
    "mix_w1": (FSDP, None),
    "mix_w2": (None, None, FSDP),
    "decay_w1": (FSDP, None),
    "decay_w2": (None, FSDP),
    "u": (MODEL, None),
    "cm_wr": (FSDP, MODEL),
    "cm_wk": (FSDP, MODEL),
    "cm_wv": (MODEL, FSDP),
    # mamba2
    "w_in": (FSDP, MODEL),
    "conv_w": (None, MODEL),
    "conv_b": (MODEL,),
    "A_log": (MODEL,),
    "D": (MODEL,),
    "dt_bias": (MODEL,),
    "norm": (MODEL,),
    "w_out": (MODEL, FSDP),
    # MoE expert-stacked tensors: the expert axis on model (expert-parallel
    # dispatch), the rest unsharded
    "we_up": (MODEL, FSDP, None),    # [E, d, F]
    "we_gate": (MODEL, FSDP, None),
    "we_down": (MODEL, None, FSDP),  # [E, F, d]
}


@dataclass(frozen=True)
class ShardingOptions:
    fsdp: bool = False              # ZeRO-3 parameter sharding over "data"
    seq_axis: str | None = None     # "model"/"data" for sequence-parallel caches
    fsdp_axis: str = "data"


def axis_sizes(mesh) -> dict[str, int]:
    """Mesh axis name -> size (a ``DeviceMesh``, or anything with
    ``axis_names`` and ``devices.shape`` as the reference's meshes)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _resolve(spec: tuple, shape: tuple, opts: ShardingOptions, sizes: dict) -> P:
    tail = [opts.fsdp_axis if (s == FSDP and opts.fsdp) else (None if s == FSDP else s)
            for s in spec]
    # drop axes missing from the mesh or not dividing the dimension
    off = len(shape) - len(tail)
    for i, s in enumerate(tail):
        if s is None:
            continue
        size = sizes.get(s)
        if size is None or shape[off + i] % size != 0:
            tail[i] = None
    return P(*((None,) * off + tuple(tail)))


def _leaf_name(path: tuple) -> str:
    """The last dict key on a tree path (list indices are digits)."""
    names = [k for k in path if not k.isdigit()]
    return names[-1] if names else ""


def param_pspecs(params, opts: ShardingOptions, mesh):
    """A spec tree matching ``params`` (tensors, meta ones too; a number is
    a 0-d leaf)."""
    sizes = axis_sizes(mesh)

    def spec_for(path, leaf) -> P:
        shape = tuple(getattr(leaf, "shape", ()))  # a number is 0-d
        base = PARAM_RULES.get(_leaf_name(path), ())
        if len(base) > len(shape):
            base = base[-len(shape):]
        return _resolve(base, shape, opts, sizes)

    return tree.rebuild(params, spec_for)


def opt_pspecs(opt_state, pspecs, opts: ShardingOptions, mesh):
    """Optimizer moments inherit the parameter specs (an int8 moment's
    scalar scale stays replicated)."""

    def match(path, ps):
        if isinstance(tree.get(opt_state["m"], path), dict):  # {"q", "s"}
            return {"q": ps, "s": P()}
        return ps

    return {"step": P(), "m": map_specs(pspecs, match), "v": map_specs(pspecs, match)}


def batch_pspec(mesh, *, seq_axis=None) -> P:
    return P(batch_axes_of(mesh), seq_axis)


def cache_pspecs(cache, mesh, opts: ShardingOptions):
    """KV and recurrent cache sharding: batch over the data axes; the
    sequence axis of global caches over ``opts.seq_axis`` (flash-decode
    style); kv head axes unsharded (kv heads are often fewer than the model
    axis)."""
    sizes = axis_sizes(mesh)
    baxes = batch_axes_of(mesh)

    def fit(shape, tail) -> P:
        """Drop axes that do not divide; pad leading dims with None."""
        off = len(shape) - len(tail)
        out = []
        for i, s in enumerate(tail):
            if s is None:
                out.append(None)
                continue
            size = 1
            for a in (s if isinstance(s, tuple) else (s,)):
                size *= sizes.get(a, 1)
            out.append(s if shape[off + i] % size == 0 else None)
        return P(*((None,) * off + tuple(out)))

    def spec_for(path, leaf) -> P:
        name, nd, shape = _leaf_name(path), leaf.ndim, tuple(leaf.shape)
        if name == "pos" or nd == 0:
            return P()
        if name in ("k", "v", "c_kv", "k_rope"):
            tail_rank = 4 if name in ("k", "v") else 3
            return fit(shape, (baxes, opts.seq_axis) + (None,) * (tail_rank - 2))
        if name in ("wkv", "ssm"):  # [stack..., B, H, p, n]
            return fit(shape, (baxes, "model", None, None))
        if name in ("shift", "cm"):  # [stack..., B, d]
            return fit(shape, (baxes, None))
        if name == "conv":  # [stack..., B, W-1, C]
            return fit(shape, (baxes, None, "model"))
        return P(*((None,) * nd))

    return tree.rebuild(cache, spec_for)


def placements(mesh, spec: P) -> tuple:
    """DTensor placements of one spec on ``mesh``, one per mesh dim:
    ``Shard(d)`` where the spec puts that mesh axis on tensor dim ``d``,
    else ``Replicate()``.  A tuple of axes on one dim shards it over each,
    major first (DTensor splits a dim sharded on several mesh dims in mesh
    order, so the major axis must come first in the mesh too).  An axis of
    size 1 splits nothing, so it is ``Replicate()`` there (the same layout,
    which every DTensor view can pass)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, s in enumerate(spec):
        dims = [names.index(a) for a in (() if s is None else s if isinstance(s, tuple) else (s,))]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: the axes of dim {d} are not in the mesh's order {names}")
        for i in dims:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree):
    """A spec tree -> the same tree of placement tuples (the reference's
    ``NamedSharding`` tree)."""
    return map_specs(spec_tree, lambda _, s: placements(mesh, s))


def map_specs(spec_tree, fn, prefix: tuple = ()):
    """``tree.rebuild`` for a spec tree: each ``P`` is a leaf (not a
    sequence), replaced by ``fn(path, spec)``."""
    if isinstance(spec_tree, P):
        return fn(prefix, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: map_specs(v, fn, prefix + (str(k),)) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(map_specs(v, fn, prefix + (str(i),))
                               for i, v in enumerate(spec_tree))
    return spec_tree  # None: a shared block's slot


def distribute(tensors, mesh, spec_tree):
    """Place each tensor leaf as a DTensor on ``mesh`` by its spec (every
    rank holds the whole tensor and keeps its own shard: no collective).
    A non-tensor leaf (the optimizer's integer step) stays as it is."""
    from torch.distributed.tensor import distribute_tensor

    pl = named(mesh, spec_tree)

    def one(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        return distribute_tensor(t, mesh, tree.get(pl, path), src_data_rank=None)

    return tree.rebuild(tensors, one)
