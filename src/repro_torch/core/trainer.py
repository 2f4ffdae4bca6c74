"""Group-wise residual training and enhancement (paper §3.2-3.3), port of
``repro/core/trainer.py``.

All G enhancers train at once: :class:`~repro_torch.core.enhancer.GroupEnhancers`
holds them with a leading [G] axis and one AdamW step updates every model.
Training's forward and backward are plain autograd (grouped convolutions);
grouping runs on the ``group_hist`` kernel and every inference pass (the
gate, the compress-time enhancement and decode) on the group-wise
``enhancer_fused`` kernel, which evaluates each pixel with its own group's
model only.

Faithful knobs (paper §4.1): C = 9 channels, batch of 10 slices, 300
epochs, Adam lr 1e-3 with a step decay every 30 epochs.  The slice order
comes from ``np.random.default_rng(cfg.seed)`` exactly as in the reference,
so both packages see the same batches; the He-normal init comes from a
``torch.Generator`` (tests inject the reference's draw).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core import grouping
from repro_torch.core.enhancer import GroupEnhancers, fp32_convs, hidden
from repro_torch.kernels import enhancer_fused, ops
from repro_torch.kernels.ops import resolve_device
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.optim.schedule import step_decay

# chunk size of the full-volume passes (calibration, gate): elements of the
# largest float32 intermediate, [slices, G, C, H, W] or [slices, H, W]
_CHUNK_ELEMS = 2**27


@dataclass(frozen=True)
class GWLZTrainConfig:
    n_groups: int = 20
    strategy: str = "quantile"
    channels: int = 9
    epochs: int = 300
    batch_size: int = 10
    lr: float = 1e-3
    lr_decay_every_epochs: int = 30
    lr_decay_factor: float = 0.5
    seed: int = 0
    slice_axis: int = 0
    residual_learning: bool = True  # False -> Fig. 5 "Regular" baseline
    # groups below this many pixels get identity enhancement (rscale = 0), and
    # with gate_groups a group whose enhancer hurts on the training volume too
    min_group_pixels: int = 1024
    gate_groups: bool = True


@dataclass
class GWLZModel:
    """Everything the reconstruction side needs (serialized into the stream)."""

    enhancers: GroupEnhancers
    edges: torch.Tensor  # [G+1]
    rscale: torch.Tensor  # [G] residual normalisation scale, 0 = identity
    cfg: GWLZTrainConfig = field(default_factory=GWLZTrainConfig)

    @property
    def params(self) -> dict:
        return self.enhancers.params()

    @property
    def bn_state(self) -> dict:
        return self.enhancers.state()

    @property
    def n_params(self) -> int:
        return self.enhancers.n_params

    def packed(self) -> torch.Tensor:
        """The kernel's [G, 4 + 21C] table of this model."""
        return _packed(self.enhancers, self.edges, self.rscale)


@torch.no_grad()
def _packed(enh: GroupEnhancers, edges: torch.Tensor, rscale: torch.Tensor) -> torch.Tensor:
    G, C = enh.n_groups, enh.channels
    lo, scale = grouping.group_normalizers(edges)
    bn_scale, bn_shift = enhancer_fused.fold_bn(enh.gamma, enh.beta, enh.mean, enh.var)
    return enhancer_fused.pack_enhancers(lo, scale, enh.b2, rscale, enh.w1.reshape(G, 9, C),
                                         enh.b1, bn_scale, bn_shift, enh.w2.reshape(G, 9, C))


def clock(device: torch.device) -> float:
    """Host seconds once the device's queued work is done (phase timings;
    one sync per phase boundary)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _as_slices(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.movedim(x, axis, 0).contiguous()


def _per_group_scale(r: torch.Tensor, ids: torch.Tensor, n_groups: int) -> torch.Tensor:
    """max |R| within each group (normalises the learning target)."""
    s = torch.zeros(n_groups, dtype=torch.float32, device=r.device).scatter_reduce(
        0, ids.reshape(-1).to(torch.int64), r.abs().reshape(-1), "amax")
    return torch.clamp(s, min=1e-12)


def _group_inputs(xb, idsb, edges, n_groups):
    """Normalised, masked inputs for every group: [G, B, H, W] (+ masks)."""
    lo, scale = grouping.group_normalizers(edges)
    masks = grouping.group_masks(idsb, n_groups).to(xb.dtype)
    xn = (xb[None] - lo[:, None, None, None]) / scale[:, None, None, None]
    return xn * masks, masks


def train_step(enh: GroupEnhancers, opt_state: dict, xb, rb, idsb, edges, rscale, lr: float,
               *, n_groups: int, residual_learning: bool,
               adam_cfg: AdamWConfig = AdamWConfig()) -> torch.Tensor:
    """One AdamW step for all G models at once (``enh`` and ``opt_state`` are
    updated in place).  Returns the per-group losses [G] of the active
    groups (0 for the others), on the device, without a host sync."""
    xn, masks = _group_inputs(xb, idsb, edges, n_groups)
    if residual_learning:
        safe = torch.where(rscale > 0, rscale, 1.0)
        target = rb[None] / safe[:, None, None, None] * masks
    else:  # Regular baseline: predict the normalised original directly
        lo, scale = grouping.group_normalizers(edges)
        orig = xb[None] + rb[None]
        target = (orig - lo[:, None, None, None]) / scale[:, None, None, None] * masks
    active = (rscale > 0.0).to(torch.float32)
    params = enh.params()
    with fp32_convs():  # forward and backward
        pred, new_state = enh(xn, train=True, mask=masks)
        se = (pred - target) ** 2 * masks
        losses = (se.sum(dim=(1, 2, 3)) / torch.clamp(masks.sum(dim=(1, 2, 3)), min=1.0)
                  * active)
        grads = torch.autograd.grad(losses.sum(), list(params.values()))
    adamw.update(params, opt_state, dict(zip(params, grads)), lr, adam_cfg)
    with torch.no_grad():
        enh.mean.copy_(new_state["mean"])
        enh.var.copy_(new_state["var"])
    return losses.detach()


def train_enhancers(xprime, residual, cfg: GWLZTrainConfig = GWLZTrainConfig(), *,
                    params: dict | None = None, callback=None, device=None):
    """Fit G enhancers mapping decompressed slices to residual slices.

    ``params`` (reference layout, leading [G]) replaces the random init.
    Returns (model, history); history["loss"][epoch, group] traces the
    per-group training loss (one host sync per epoch), history["seconds"]
    the time of each phase (edges, train, calibrate, gate)."""
    device = resolve_device(device)
    t = [clock(device)]
    G = cfg.n_groups
    xs = _as_slices(torch.as_tensor(xprime, dtype=torch.float32).to(device), cfg.slice_axis)
    rs = _as_slices(torch.as_tensor(residual, dtype=torch.float32).to(device), cfg.slice_axis)
    n_slices = xs.shape[0]

    edges = grouping.compute_edges(xs, G, cfg.strategy)
    ids, counts = ops.group_hist_op(xs, edges)
    rscale = _per_group_scale(rs, ids, G)
    rscale = torch.where(counts >= cfg.min_group_pixels, rscale, 0.0)
    t.append(clock(device))

    enh = GroupEnhancers(G, cfg.channels, device=device,
                         generator=torch.Generator().manual_seed(cfg.seed))
    if params is not None:
        enh.load(params)
    adam_cfg = AdamWConfig()
    opt_state = adamw.init(enh.params(), adam_cfg)

    bs = min(cfg.batch_size, n_slices)
    steps_per_epoch = max(n_slices // bs, 1)
    sched = step_decay(cfg.lr, cfg.lr_decay_factor, cfg.lr_decay_every_epochs * steps_per_epoch)
    rng = np.random.default_rng(cfg.seed)
    history = {"loss": np.zeros((cfg.epochs, G), np.float64), "lr": np.zeros(cfg.epochs)}
    gstep = 0
    for epoch in range(cfg.epochs):
        order = torch.from_numpy(rng.permutation(n_slices)).to(device)
        ep_loss = torch.zeros(G, dtype=torch.float64, device=device)
        for s in range(steps_per_epoch):
            idx = order[s * bs : (s + 1) * bs]
            losses = train_step(enh, opt_state, xs[idx], rs[idx], ids[idx], edges, rscale,
                                sched(gstep), n_groups=G,
                                residual_learning=cfg.residual_learning, adam_cfg=adam_cfg)
            ep_loss += losses.to(torch.float64)
            gstep += 1
        history["loss"][epoch] = (ep_loss / steps_per_epoch).cpu().numpy()
        history["lr"][epoch] = sched(gstep - 1)
        if callback is not None:
            callback(epoch, history["loss"][epoch])
    t.append(clock(device))
    # exact full-volume BN statistics of the final model: the data we will
    # enhance is exactly the data we trained on
    mean, var = _bn_calibrate(enh.params(), xs, ids, edges, n_groups=G)
    with torch.no_grad():
        enh.mean.copy_(mean)
        enh.var.copy_(var)
    t.append(clock(device))
    if cfg.gate_groups and cfg.residual_learning:
        gate = _gate_groups(enh, xs, rs, ids, edges, rscale)
        rscale = rscale * gate
        history["gate"] = gate.cpu().numpy()
    t.append(clock(device))
    history["seconds"] = dict(zip(("edges", "train", "calibrate", "gate"),
                                  map(float, np.diff(t))))
    return GWLZModel(enhancers=enh, edges=edges, rscale=rscale, cfg=cfg), history


def tiles_as_slices(tiles: torch.Tensor) -> torch.Tensor:
    """[Nt, T0, ...] tile batch -> one slice stack along every tile's axis 0."""
    return tiles.reshape((-1,) + tuple(tiles.shape[2:]))


def train_enhancers_tiled(recon_tiles: torch.Tensor, residual_tiles: torch.Tensor,
                          cfg: GWLZTrainConfig = GWLZTrainConfig(), *,
                          params: dict | None = None, callback=None, device=None):
    """Group-wise training over the tile grid: every tile's axis-0 slices go
    into ONE :func:`train_enhancers` call, so the grid trains like a taller
    volume.  Needs 3D tiles [Nt, T, T, T]."""
    if recon_tiles.ndim != 4 or residual_tiles.shape != recon_tiles.shape:
        raise ValueError(f"expected matching [Nt, T, T, T] tile stacks, got "
                         f"{tuple(recon_tiles.shape)} / {tuple(residual_tiles.shape)}")
    cfg = replace(cfg, slice_axis=0)  # tile slices are already stacked on axis 0
    return train_enhancers(tiles_as_slices(recon_tiles), tiles_as_slices(residual_tiles),
                           cfg, params=params, callback=callback, device=device)


@torch.no_grad()
def _gate_groups(enh: GroupEnhancers, xs, rs, ids, edges, rscale, *,
                 chunk_slices: int | None = None) -> torch.Tensor:
    """Per-group acceptance on the training volume: keep a group's enhancer
    only if it lowers that group's residual sum of squares.  Runs in chunks
    of slices with float64 sums; returns float32 0/1 [G]."""
    G = enh.n_groups
    packed = _packed(enh, edges, rscale)
    S = chunk_slices or max(1, _CHUNK_ELEMS // (xs.shape[1] * xs.shape[2]))
    err_with = torch.zeros(G, dtype=torch.float64, device=xs.device)
    err_without = torch.zeros_like(err_with)
    for i in range(0, xs.shape[0], S):
        idc, rc = ids[i : i + S], rs[i : i + S]
        pred = ops.enhancer_grouped_op(xs[i : i + S], idc, packed, mode="pred")
        rhat = pred * rscale[idc.to(torch.int64)]
        flat = idc.reshape(-1).to(torch.int64)
        err_with += torch.bincount(flat, ((rc - rhat) ** 2).reshape(-1).double(), minlength=G)
        err_without += torch.bincount(flat, (rc ** 2).reshape(-1).double(), minlength=G)
    return (err_with < err_without).to(torch.float32)


@torch.no_grad()
def _bn_calibrate(params: dict, xs, ids, edges, *, n_groups: int,
                  chunk_slices: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact masked BN statistics (mean, var [G, C]) of the final model over
    the full volume.  Two passes over chunks of slices (mean, then the
    variance about that mean), summed in float64."""
    G, C = n_groups, params["w1"].shape[-1]
    S = chunk_slices or max(1, _CHUNK_ELEMS // (G * C * xs.shape[1] * xs.shape[2]))
    dev = xs.device
    cnt = torch.zeros(G, dtype=torch.float64, device=dev)
    s1 = torch.zeros((G, C), dtype=torch.float64, device=dev)
    s2 = torch.zeros_like(s1)

    def chunks():
        for i in range(0, xs.shape[0], S):
            xn, m = _group_inputs(xs[i : i + S], ids[i : i + S], edges, G)
            yield hidden(params, xn), m.transpose(0, 1).unsqueeze(2)  # [S,G,C,H,W], [S,G,1,H,W]

    for h, m in chunks():
        s1 += (h * m).sum(dim=(0, 3, 4), dtype=torch.float64)
        cnt += m.sum(dim=(0, 2, 3, 4), dtype=torch.float64)
    denom = torch.clamp(cnt, min=1.0)[:, None]
    mean = (s1 / denom).to(torch.float32)
    for h, m in chunks():
        s2 += ((h - mean[None, :, :, None, None]) ** 2 * m).sum(dim=(0, 3, 4),
                                                                dtype=torch.float64)
    return mean, (s2 / denom).to(torch.float32)


def _enhance_slices(model: GWLZModel, xs: torch.Tensor, *,
                    clamp_eb: float | None = None) -> torch.Tensor:
    """Slices [B, H, W] -> enhanced slices: group ids from ``group_hist``,
    then every pixel through its own group's model (``enhancer_fused``).
    Each pixel's value is independent of the batch, so any subset of
    slices or tiles enhances to the same bits as the whole."""
    ids = grouping.assign_groups(xs, model.edges)
    mode = "residual" if model.cfg.residual_learning else "direct"
    return ops.enhancer_grouped_op(xs, ids, model.packed(), mode=mode, clamp_eb=clamp_eb)


def enhance(xprime, model: GWLZModel, *, clamp_eb: float | None = None,
            device=None) -> torch.Tensor:
    """Reconstruction module: X_hat = X' + R_hat, merged across groups.

    ``clamp_eb`` clips the enhanced value into [X'-e, X'+e] (bounded
    enhancement: the worst-case error vs the original is then 2e)."""
    device = resolve_device(device)
    axis = model.cfg.slice_axis
    xs = _as_slices(torch.as_tensor(xprime, dtype=torch.float32).to(device), axis)
    return torch.movedim(_enhance_slices(model, xs, clamp_eb=clamp_eb), 0, axis)


def enhance_tiles(tiles: torch.Tensor, model: GWLZModel, *,
                  clamp_eb: float | None = None) -> torch.Tensor:
    """Per-tile enhancement ``[K, *tile] -> [K, *tile]`` (3D tiles), on the
    tiles' device.  Every tile is enhanced exactly as :func:`enhance`
    enhances it alone, whatever K is."""
    ax = 1 + model.cfg.slice_axis
    moved = torch.movedim(tiles, ax, 1)
    out = _enhance_slices(model, tiles_as_slices(moved).contiguous(), clamp_eb=clamp_eb)
    return torch.movedim(out.reshape(moved.shape), 1, ax)
