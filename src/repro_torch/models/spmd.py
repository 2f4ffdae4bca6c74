"""Per-rank computation on DTensors: the pieces that let the models run
on a ``DeviceMesh`` (the dry run's sharded traces, a sharded training
step) where DTensor's own rules do not serve.

DTensor shards an op by propagating placements through its views, and the
views of an einsum, an embedding lookup or a head split merge or split a
sharded dim, which the older release the card runs (torch 2.11) refuses.
So each piece here takes each rank's shards (``to_local``), does the
plain op on them, and wraps the result back with the placements the
op's semantics give (``from_local``), as XLA partitions the reference's
dots and gathers; collectives are ``c10d_functional`` ones, so
``launch/opcount.py`` counts them.  On plain tensors every function here
is the plain op, so the single-device path's numbers do not move.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def all_reduce_over(t: torch.Tensor, mesh, dims, op: str = "sum") -> torch.Tensor:
    """A per-rank tensor reduced over the mesh dims ``dims`` (indices)."""
    from torch.distributed import _functional_collectives as funcol

    for d in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, d)))
    return t


def local_block(t, dim: int) -> tuple[int, int]:
    """(offset, size) of this rank's block of a DTensor's ``dim``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    return offset[dim], shape[dim]


def whole(t) -> torch.Tensor:
    """A replicated DTensor (or a plain tensor) as the plain whole tensor."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def replicate_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor sharded on ``dim`` gathered on that dim; anything else as
    it is: a stacked leaf whose layer dim a rule shards (rwkv6's ``wk``
    [L, d, d] takes attention's [d, H, hd] rule) before its layers are
    taken apart, a dim :func:`reshape` cannot split or merge sharded."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    d = dim % x.ndim
    if Shard(d) not in x.placements:
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p == Shard(d) else p
                                          for p in x.placements])


class ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient comes back contiguous: a rank computing on
    its shards hands their gradients back to DTensor, whose views need
    them contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def settled(t):
    """A DTensor with its pending partial sums reduced (whole on those mesh
    dims)."""
    from torch.distributed.tensor import Replicate

    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of operands without ``...``.  On DTensors it runs on
    each rank's shards: per mesh dim one label is kept sharded (every
    operand with that label sharded on it, the others whole there), so the
    local einsum gives the output's shard (a kept output label) or a
    partial sum (a kept contracted one), as XLA partitions a dot.  The
    label kept is the one that gathers the fewest bytes (operands sharded
    on another label are gathered; a tie keeps the first operand's: the
    activations', so FSDP weights are gathered).  DTensor's own rule goes
    through views that older releases refuse."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(t, DTensor) for t in ops):
        return torch.einsum(eq, *ops)
    return _einsum_sharded(eq, ops)


def _einsum_sharded(eq: str, ops) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    ins, out = eq.split("->")
    ins = ins.split(",")
    mesh = next(t for t in ops if isinstance(t, DTensor)).device_mesh
    ops = [settled(t) if isinstance(t, DTensor)
           else DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
           for t in ops]
    sizes = {lbl: n for lbls, t in zip(ins, ops) for lbl, n in zip(lbls, t.shape)}
    want = [[Replicate()] * mesh.ndim for _ in ops]
    out_pl = [Replicate()] * mesh.ndim
    for i in range(mesh.ndim):
        sharded = [ins[j][t.placements[i].dim] if t.placements[i].is_shard() else None
                   for j, t in enumerate(ops)]
        labels = [lbl for lbl in sharded if lbl is not None
                  and sizes[lbl] % mesh.size(i) == 0]
        if not labels:
            continue
        keep = min(labels, key=lambda lbl: sum(
            t.numel() for t, own in zip(ops, sharded) if own is not None and own != lbl))
        for j, lbls in enumerate(ins):
            if keep in lbls:
                want[j][i] = Shard(lbls.index(keep))
        out_pl[i] = Shard(out.index(keep)) if keep in out else Partial()
    local = []
    for t, w in zip(ops, want):
        t = t.redistribute(mesh, w)
        grad = [p if p.is_shard() else Replicate() if o == Replicate() else Partial()
                for p, o in zip(w, out_pl)]
        local.append(ContiguousGrad.apply(t.to_local(grad_placements=grad)))
    y = torch.einsum(eq, *local)
    shape = torch.Size(sizes[lbl] for lbl in out)
    return DTensor.from_local(y, mesh, out_pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


class RowBlocks:
    """Per-rank computation on a tensor's batch rows.  For a DTensor ``x``,
    ``local`` gives a DTensor as this rank's block (split on a dim over the
    mesh dims that split ``x``'s rows, whole on the others), ``param`` a
    parameter whole (its gradient a partial sum over those mesh dims: each
    rank's rows give their share) and ``wrap`` a per-rank result back as a
    DTensor.  For a plain ``x`` all three are the identity."""

    def __init__(self, x: torch.Tensor):
        from torch.distributed.tensor import DTensor, Shard

        self.mesh = x.device_mesh if isinstance(x, DTensor) else None
        self.rows = ([] if self.mesh is None else
                     [i for i, p in enumerate(x.placements) if p == Shard(0)])

    def _placements(self, dim: int, other) -> list:
        from torch.distributed.tensor import Shard

        return [Shard(dim) if i in self.rows else other for i in range(self.mesh.ndim)]

    def local(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        from torch.distributed.tensor import Replicate

        if self.mesh is None:
            return t
        return t.redistribute(self.mesh, self._placements(dim, Replicate())).to_local()

    def param(self, t: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import Partial, Replicate

        if self.mesh is None:
            return t
        whole = [Replicate()] * self.mesh.ndim
        return t.redistribute(self.mesh, whole).to_local(
            grad_placements=[Partial() if i in self.rows else Replicate()
                             for i in range(self.mesh.ndim)])

    def wrap(self, t: torch.Tensor, dim: int | None = 0) -> torch.Tensor:
        """``t`` split on ``dim`` over the row dims (``dim=None``: a per-rank
        value whose mean over them is the whole's)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        if self.mesh is None:
            return t
        pl = ([Partial("avg") if i in self.rows else Replicate() for i in range(self.mesh.ndim)]
              if dim is None else self._placements(dim, Replicate()))
        shape = list(t.shape)
        if dim is not None:
            for i in self.rows:
                shape[dim] *= self.mesh.size(i)
        shape = torch.Size(shape)
        return DTensor.from_local(t, self.mesh, pl, run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())


class _SumOver(torch.autograd.Function):
    """Per-rank partials summed over mesh dims; what reads the sum is the
    same on every rank, so each partial's gradient is the sum's."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        return all_reduce_over(t, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``.  On a DTensor table whose vocab dim
    is sharded, each rank looks up the tokens its rows hold (zeros for the
    others) and the ranks along the vocab's mesh dims sum them: a masked
    gather and an all-reduce, as XLA partitions the reference's gather
    (DTensor's own rule leaves a masked partial that its backward cannot
    always reduce).  The table's other shards (FSDP) are gathered first."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(table, DTensor):
        return F.embedding(tokens.to(torch.int64), table)
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    table = table.redistribute(mesh, [Shard(0) if i in vocab else Replicate()
                                      for i in range(mesh.ndim)])
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    tokens = tokens.redistribute(mesh, [Replicate() if i in vocab or not p.is_shard() else p
                                        for i, p in enumerate(tokens.placements)])
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    (vl, d), (v0, _) = compute_local_shape_and_global_offset(table.shape, mesh, table.placements)
    local = table.to_local(grad_placements=[Shard(0) if i in vocab else Partial()
                                            for i in range(mesh.ndim)])
    idx = tokens.to_local().to(torch.int64) - v0
    inside = (idx >= 0) & (idx < vl)
    x = F.embedding(torch.clamp(idx, 0, vl - 1), local) * inside[..., None].to(local.dtype)
    x = _SumOver.apply(x, mesh, vocab)
    shape = torch.Size((*tokens.shape, d))
    return DTensor.from_local(x, mesh, tokens.placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _viewable(t, shape):
    """``t`` (a DTensor) gathered on each dim a reshape to ``shape`` changes
    but cannot carry its shard: a changed dim other than the first, or a
    first one whose old or new size the shard count does not divide."""
    from torch.distributed.tensor import Shard

    k = 0
    while k < min(t.ndim, len(shape)) and t.shape[k] == shape[k]:
        k += 1
    n = {}
    for i, p in enumerate(t.placements):
        if p.is_shard() and p.dim >= k:
            n[p.dim] = n.get(p.dim, 1) * t.device_mesh.size(i)
    for d, count in n.items():
        if d != k or t.shape[k] % count or k >= len(shape) or shape[k] % count:
            t = replicate_dim(t, d)
    return t


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose gradient is gathered where it must be too
    (a gradient may come back sharded where the forward input was not)."""

    @staticmethod
    def forward(ctx, t, shape):
        ctx.shape = t.shape
        return _viewable(t, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _viewable(g, ctx.shape).reshape(ctx.shape), None


def reshape(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t.reshape(shape)``; a DTensor sharded on a dim the reshape splits
    or merges unevenly is gathered there first (and its gradient so on
    the way back): rwkv6's [B, T, d] -> [B, T, H, hd] with fewer heads than
    the model axis."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t.reshape(shape)
    return _Reshape.apply(t, torch.Size(shape))
