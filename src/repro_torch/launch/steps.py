"""The LM steps, port of ``repro/launch/steps.py`` (``:20-142``): the
training step (loss, gradients, warm-up cosine learning rate and an AdamW
update with weight decay 0.1 and the chosen moment dtype), microbatched
when ``TrainOptions.microbatch`` > 1, the prefill step and the decode
step, of a decoder or an encoder-decoder.

With a ``mesh`` (a ``DeviceMesh``) the trees passed in are DTensors
placed by ``launch/sharding.py``'s specs, and each step runs under
``implicit_replication()``: the plain tensors a model makes inside (rope
tables, positions, masks, the MoE dispatch's buffers) take part as
replicated DTensors.  Activations are constrained to batch-sharded after
the embedding and every layer (``batch_axes``), as in the reference.
Without a mesh every step is the plain-tensor one.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from repro_torch import tree
from repro_torch.launch.mesh import batch_axes_of
from repro_torch.models.common import shard_constraint
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.optim.schedule import warmup_cosine


@dataclass(frozen=True)
class TrainOptions:
    lr: float = 3e-4
    warmup: int = 2000
    total_steps: int = 100_000
    moment_dtype: str = "bf16"
    fsdp: bool = False           # ZeRO-3 parameter sharding (read by the dry run's specs)
    microbatch: int = 1          # gradient-accumulation chunks
    param_dtype: str = "fp32"    # the reference's field; neither package reads it


def _on_mesh(mesh):
    """The step's context: plain tensors join DTensors as replicated ones
    on a mesh; nothing without one."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _positions(batch: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The batch's positions ([B, 3, S] under M-RoPE), else ``arange(S)``."""
    pos = batch.get("positions")
    return torch.arange(tokens.shape[1], device=tokens.device) if pos is None else pos


def make_train_step(model, cfg, opts: TrainOptions, mesh=None, grad_pspecs=None):
    """Returns (train_step, adam_cfg).  ``train_step(params, opt_state,
    batch, rng) -> (params, opt_state, {"loss", "lr"})`` updates the
    parameter tree and the optimizer state in place; ``batch`` holds
    ``tokens`` and ``targets`` [B, S] on the model's device, and ``rng`` is
    the step's key (it seeds the int8 moments' stochastic rounding).  A
    batch may carry ``positions`` ([B, 3, S] under M-RoPE; else
    ``arange(S)``), and an encoder-decoder's carries ``enc_feats``.

    With ``opts.microbatch`` = M > 1 the batch is split [B, ...] ->
    [M, B/M, ...] (the inner batch dim on the mesh's batch axes), the
    float32 gradients of the M microbatches are summed into one
    accumulator (constrained to ``grad_pspecs``, a spec tree, when given:
    each microbatch's gradients are then reduce-scattered into it), and
    gradients and loss are divided by M, as the reference's ``lax.scan``
    does."""
    adam_cfg = AdamWConfig(weight_decay=0.1, moment_dtype=opts.moment_dtype)
    lr_fn = warmup_cosine(opts.lr, opts.warmup, opts.total_steps)
    baxes = batch_axes_of(mesh) if mesh is not None else None

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        if cfg.enc_layers > 0:
            return model.loss(params, batch["enc_feats"], tokens, batch["targets"],
                              batch_axes=baxes)
        return model.loss(params, tokens, batch["targets"], _positions(batch, tokens),
                          batch_axes=baxes)

    def grads_of(leaves, loss):
        # a leaf no forward reads (rwkv6's ``ffn``) gets a zero gradient, as
        # under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]

    def resplit(t: torch.Tensor) -> torch.Tensor:
        """[B, ...] -> [M, B/M, ...], each microbatch spanning every device.
        A DTensor's rows are split where they lie (each rank's rows into M
        runs; microbatch m holds run m of every rank: the same M-way
        partition of the batch as the reference's when one rank holds it,
        and no row moves); DTensor cannot split a sharded dim."""
        M = opts.microbatch
        from torch.distributed.tensor import DTensor, Replicate, Shard

        if not isinstance(t, DTensor):
            return t.reshape(M, t.shape[0] // M, *t.shape[1:])
        local = t.to_local()
        local = local.reshape(M, local.shape[0] // M, *local.shape[1:])
        placements = [Shard(1) if p == Shard(0) else Replicate() for p in t.placements]
        shape = torch.Size((M, t.shape[0] // M, *t.shape[1:]))
        return DTensor.from_local(local, t.device_mesh, placements, run_check=False,
                                  shape=shape, stride=torch.empty(shape, device="meta").stride())

    def train_step(params, opt_state, batch, rng):
        paths, leaves = zip(*tree.leaves(params))
        for p in leaves:  # restored leaves come back as plain tensors
            p.requires_grad_(True)
        M = opts.microbatch
        with _on_mesh(mesh):
            if M <= 1:
                loss, _ = loss_fn(params, batch)
                grads = grads_of(leaves, loss)
            else:
                split = {k: resplit(v) for k, v in batch.items()}
                grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
                loss = None
                for m in range(M):
                    l, _ = loss_fn(params, {k: v[m] for k, v in split.items()})
                    for acc, g in zip(grads, grads_of(leaves, l)):
                        acc.add_(g)
                    if grad_pspecs is not None:
                        grads = [shard_constraint(acc, tree.get(grad_pspecs, path))
                                 for path, acc in zip(paths, grads)]
                    loss = l.detach() if loss is None else loss + l.detach()
                for g in grads:
                    g.div_(M)
                loss = loss / M
            by_path = dict(zip(paths, grads))
            lr = lr_fn(int(opt_state["step"]))
            adamw.update(params, opt_state, tree.rebuild(params, lambda path, _: by_path[path]),
                         lr, adam_cfg, rng)
        return params, opt_state, {"loss": loss.detach(), "lr": lr}

    return train_step, adam_cfg


def make_prefill_step(model, cfg, mesh=None):
    """Forward over the full prompt: ``prefill_step(params, batch) ->
    logits [B, V]`` at the last position (no gradient; the cache is not
    written, which changes no FLOP, as in the reference).  ``batch`` holds
    ``tokens`` [B, S] (and ``positions`` under M-RoPE); an
    encoder-decoder's also ``enc_feats``, encoded first."""
    baxes = batch_axes_of(mesh) if mesh is not None else None

    @torch.no_grad()
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        with _on_mesh(mesh):
            if cfg.enc_layers > 0:
                enc_out = model.encode(params, batch["enc_feats"], batch_axes=baxes)
                pos = torch.arange(tokens.shape[1], device=tokens.device)
                logits, _ = model.decode(params, enc_out, tokens, pos, batch_axes=baxes)
            else:
                logits, _, _ = model.apply(params, tokens, _positions(batch, tokens),
                                           batch_axes=baxes)
            return logits[:, -1]

    return prefill_step


def make_decode_step(model, mesh=None):
    """One new token against a filled cache: ``decode_step(params, cache,
    batch) -> (logits [B, V], cache)`` with ``batch`` holding ``token``
    [B, 1] and ``pos``, the absolute position, and for an encoder-decoder
    ``enc_out``, the encoder's output.  The cache is written in place
    (``DecoderLM.decode_step``, ``EncDecLM.decode_step``)."""
    baxes = batch_axes_of(mesh) if mesh is not None else None
    if model.cfg.enc_layers > 0:
        def decode_step(params, cache, batch):
            with _on_mesh(mesh):
                return model.decode_step(params, cache, batch["enc_out"], batch["token"],
                                         batch["pos"], batch_axes=baxes)
    else:
        def decode_step(params, cache, batch):
            with _on_mesh(mesh):
                return model.decode_step(params, cache, batch["token"], batch["pos"],
                                         batch_axes=baxes)

    return decode_step
