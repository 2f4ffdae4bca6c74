"""Plain group-wise enhancer training (paper §3.2-3.3, §4.1), in torch with
TF32 off: the first steps of a GWLZ compress, worked out from the field and
its SZ reconstruction alone.

The training set is the reconstruction's tiles cut into slices along each
tile's first axis, and the residual ``x - x'`` of the same slices.  Groups
are value quantiles of the whole set: the ``G + 1`` edges interpolate the
sorted values linearly at positions ``i * float32(1/G) * float32(n - 1)``
(float32, as a float32 quantile is defined there); an edge within a
millionth of the range of the one kept before it is dropped and the list
padded past the top by a thousandth of the range.  A value's group is the
number of the first ``G`` edges at or below it, less one.  A group with
fewer than ``min_group_pixels`` values, or none, trains no model (its
residual scale is 0); another group's residual scale is the largest
``|x - x'|`` in it.

Each group's model is conv3x3 (1 -> C) -> BatchNorm -> ReLU -> conv3x3
(C -> 1), zero padding, on the slice normalised by the group's (lo, width)
with other groups' pixels set to 0.  In training, BatchNorm takes the mean
and the biased variance of the group's own pixels in the batch.  A group's
loss is the mean over its pixels of ``(pred - r / rscale)^2``; a step's
loss is the sum over the groups.  Weights start He-normal from a
``torch.Generator`` seeded with the configuration's seed (w1 ``[G, 3, 3,
1, C]`` then w2 ``[G, 3, 3, C, 1]``, each ``randn * sqrt(2 / fan_in)``),
biases 0, BN scale 1.  Batches are ``batch_size`` slices in the order of
``numpy.random.default_rng(seed).permutation``.  The optimizer is Adam
(bias-corrected moments, ``lr * m_hat / (sqrt(v_hat) + eps)``) at the
schedule's rate.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.enhancer import BN_EPS, group_ids

LEAVES = ("b1", "b2", "beta", "gamma", "w1", "w2")
NUMBERS = ("train_init_bad", "train_loss_gap", "train_grad_gap", "train_step_gap")


def slices(tiles: torch.Tensor) -> torch.Tensor:
    """Tiles [K, T0, T1, T2] -> slices [K * T0, T1, T2] along each tile's axis 0."""
    return tiles.reshape(-1, *tiles.shape[2:])


def quantile_edges(xs: torch.Tensor, G: int) -> torch.Tensor:
    srt = torch.sort(xs.reshape(-1).to(torch.float32)).values
    n = srt.numel()
    step = np.float32(1.0 / G)
    pos = [np.float32(np.float32(i) * step) * np.float32(n - 1) for i in range(G)]
    pos.append(np.float32(n - 1))
    vals = []
    for p in pos:
        lo, hi = min(math.floor(p), n - 1), min(math.ceil(p), n - 1)
        w = float(p) - math.floor(p)  # exact: p is a float32
        wl = float(np.float32(1.0 - w))
        a, b = float(srt[lo]), float(srt[hi])
        vals.append(float(np.float32(b * w + float(np.float32(a * wl)))))
    span = max(vals[-1] - vals[0], 1e-30)
    keep = [vals[0]]
    for v in vals[1:]:
        if v - keep[-1] > span * 1e-6:
            keep.append(v)
    while len(keep) < G + 1:
        keep.append(keep[-1] + span * 1e-3)
    return torch.tensor(np.asarray(keep, np.float32), device=xs.device)


def init_params(G: int, C: int, seed: int, device, dtype=torch.float32) -> dict:
    gen = torch.Generator().manual_seed(seed)
    w1 = torch.randn((G, 3, 3, 1, C), generator=gen) * (2.0 / 9) ** 0.5
    w2 = torch.randn((G, 3, 3, C, 1), generator=gen) * (2.0 / (9 * C)) ** 0.5
    p = {"b1": torch.zeros(G, C), "b2": torch.zeros(G, 1), "beta": torch.zeros(G, C),
         "gamma": torch.ones(G, C), "w1": w1, "w2": w2}
    return {k: v.to(device, dtype) for k, v in p.items()}


def _loss(p: dict, x, r, ids, lo, width, rscale, active) -> torch.Tensor:
    """The summed loss of every group with a model on one batch [B, H, W]."""
    total = x.new_zeros(())
    for g in active:
        m = (ids == g).to(x.dtype)[:, None]
        xin = (x[:, None] - lo[g]) / width[g] * m
        h = F.conv2d(xin, p["w1"][g].permute(3, 2, 0, 1), p["b1"][g], padding=1)
        cnt = torch.clamp(m.sum(), min=1.0)
        mean = (h * m).sum(dim=(0, 2, 3)) / cnt
        var = (((h - mean[None, :, None, None]) ** 2) * m).sum(dim=(0, 2, 3)) / cnt
        h = (h - mean[None, :, None, None]) * torch.rsqrt(var + BN_EPS)[None, :, None, None]
        h = torch.relu(h * p["gamma"][g][None, :, None, None]
                       + p["beta"][g][None, :, None, None])
        pred = F.conv2d(h, p["w2"][g].permute(3, 2, 0, 1), p["b2"][g], padding=1)
        target = r[:, None] / rscale[g] * m
        total = total + (((pred - target) ** 2) * m).sum() / cnt
    return total


def first_steps(sz_tiles: torch.Tensor, x_tiles: torch.Tensor, enh: dict, adam: dict, *,
                steps: int = 3, dtype=torch.float32) -> dict:
    """Train from the seed's init for ``steps`` steps.  Returns the init,
    each step's loss, the first step's gradient and the parameters after
    the last step (float32 tensors a leaf)."""
    G, C = enh["n_groups"], enh["channels"]
    if enh["strategy"] != "quantile" or not enh["residual_learning"]:
        raise ValueError("the reference trains quantile groups with residual learning only")
    dev = sz_tiles.device
    xs = slices(sz_tiles.to(torch.float32))
    rs = slices(x_tiles.to(torch.float32)) - xs
    edges = quantile_edges(xs, G)
    ids = group_ids(xs, edges)
    flat = ids.reshape(-1).to(torch.int64)
    counts = torch.bincount(flat, minlength=G)
    amax = torch.zeros(G, device=dev).scatter_reduce(0, flat, rs.abs().reshape(-1), "amax")
    rscale = torch.where(counts >= enh["min_group_pixels"], torch.clamp(amax, min=1e-12), 0.0)
    active = [g for g in range(G) if float(rscale[g]) > 0.0]
    lo = edges[:-1].to(dtype)
    width = torch.clamp(edges[1:] - edges[:-1], min=1e-12).to(dtype)
    rsc = rscale.to(dtype)

    p = init_params(G, C, enh["seed"], dev, dtype)
    init = {k: v.to(torch.float32).clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = adam["b1"], adam["b2"], adam["eps"]
    bs = min(enh["batch_size"], xs.shape[0])
    per_epoch = max(xs.shape[0] // bs, 1)
    order = np.random.default_rng(enh["seed"]).permutation(xs.shape[0])
    losses, grad0 = [], None
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for t in range(1, steps + 1):
            idx = torch.from_numpy(order[(t - 1) * bs:t * bs]).to(dev)
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            loss = _loss(leaves, xs[idx].to(dtype), rs[idx].to(dtype), ids[idx], lo, width,
                         rsc, active)
            grads = torch.autograd.grad(loss, [leaves[k] for k in LEAVES], allow_unused=True)
            grads = {k: torch.zeros_like(p[k]) if g is None else g
                     for k, g in zip(LEAVES, grads)}
            losses.append(float(loss.detach()))
            if grad0 is None:
                grad0 = {k: g.to(torch.float32).clone() for k, g in grads.items()}
            lr = enh["lr"] * enh["lr_decay_factor"] ** (
                (t - 1) // (enh["lr_decay_every_epochs"] * per_epoch))
            with torch.no_grad():
                for k in LEAVES:
                    g = grads[k]
                    m[k] = b1 * m[k] + (1 - b1) * g
                    v2[k] = b2 * v2[k] + (1 - b2) * g * g
                    mh = m[k] / (1 - b1 ** t)
                    vh = v2[k] / (1 - b2 ** t)
                    p[k] = p[k] - lr * mh / (torch.sqrt(vh) + eps)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    return {"init": init, "loss": losses, "grad": grad0,
            "params": {k: v.to(torch.float32) for k, v in p.items()}}


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers the check compares: the init's values that differ; the
    largest relative gap of a step's loss; and, by the worst leaf, the gap
    between the program's and the reference's norms of the first gradient
    and of the parameters' change, each over the reference's norm of that
    leaf or of the median leaf, whichever is larger.  A leaf whose
    reference gradient is under a thousandth of the median leaf's moves by
    round-off alone and is left out of the change."""
    init_bad = sum(int((prog["init"][k].to(ref["init"][k].device) != ref["init"][k]).sum())
                   for k in LEAVES)
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["loss"], ref["loss"]))
    g_ref = {k: norm(ref["grad"][k]) for k in LEAVES}
    g_med = float(np.median(list(g_ref.values())))
    grad = max(abs(norm(prog["grad"][k]) - g_ref[k]) / max(g_ref[k], g_med, 1e-30)
               for k in LEAVES)
    moved = [k for k in LEAVES if g_ref[k] >= 1e-3 * g_med]
    d_ref = {k: norm(ref["params"][k] - ref["init"][k]) for k in moved}
    d_med = float(np.median(list(d_ref.values())))
    step = max(abs(norm(prog["params"][k].to(ref["init"][k].device) - ref["init"][k])
                   - d_ref[k]) / max(d_ref[k], d_med, 1e-30) for k in moved)
    return dict(zip(NUMBERS, (init_bad, loss, grad, step)))
