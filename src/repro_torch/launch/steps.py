"""The LM steps, port of ``repro/launch/steps.py``: the training step
(``:21-98``) for one microbatch (loss, gradients, warm-up cosine learning
rate and an AdamW update with weight decay 0.1 and the chosen moment
dtype), and the decode step (``:124-142``) of a decoder or an
encoder-decoder.  Microbatching and the prefill step wait for their
caller (the dry run)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import tree
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.optim.schedule import warmup_cosine


@dataclass(frozen=True)
class TrainOptions:
    lr: float = 3e-4
    warmup: int = 2000
    total_steps: int = 100_000
    moment_dtype: str = "bf16"


def make_train_step(model, cfg, opts: TrainOptions):
    """Returns (train_step, adam_cfg).  ``train_step(params, opt_state,
    batch, rng) -> (params, opt_state, {"loss", "lr"})`` updates the
    parameter tree and the optimizer state in place; ``batch`` holds
    ``tokens`` and ``targets`` [B, S] on the model's device, and ``rng`` is
    the step's key (it seeds the int8 moments' stochastic rounding).  A
    batch may carry ``positions`` ([B, 3, S] under M-RoPE; else
    ``arange(S)``), and an encoder-decoder's carries ``enc_feats``."""
    adam_cfg = AdamWConfig(weight_decay=0.1, moment_dtype=opts.moment_dtype)
    lr_fn = warmup_cosine(opts.lr, opts.warmup, opts.total_steps)

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        if cfg.enc_layers > 0:
            return model.loss(params, batch["enc_feats"], tokens, batch["targets"])
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        return model.loss(params, tokens, batch["targets"], positions)

    def train_step(params, opt_state, batch, rng):
        paths, leaves = zip(*tree.leaves(params))
        for p in leaves:  # restored leaves come back as plain tensors
            p.requires_grad_(True)
        loss, _ = loss_fn(params, batch)
        # a leaf no forward reads (rwkv6's ``ffn``) gets a zero gradient, as
        # under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_path = {path: torch.zeros_like(p) if g is None else g
                   for path, p, g in zip(paths, leaves, grads)}
        lr = lr_fn(int(opt_state["step"]))
        adamw.update(params, opt_state, tree.rebuild(params, lambda path, _: by_path[path]),
                     lr, adam_cfg, rng)
        return params, opt_state, {"loss": loss.detach(), "lr": lr}

    return train_step, adam_cfg


def make_decode_step(model):
    """One new token against a filled cache: ``decode_step(params, cache,
    batch) -> (logits [B, V], cache)`` with ``batch`` holding ``token``
    [B, 1] and ``pos``, the absolute position, and for an encoder-decoder
    ``enc_out``, the encoder's output.  The cache is written in place
    (``DecoderLM.decode_step``, ``EncDecLM.decode_step``)."""
    if model.cfg.enc_layers > 0:
        def decode_step(params, cache, batch):
            return model.decode_step(params, cache, batch["enc_out"], batch["token"],
                                     batch["pos"])
    else:
        def decode_step(params, cache, batch):
            return model.decode_step(params, cache, batch["token"], batch["pos"])

    return decode_step
