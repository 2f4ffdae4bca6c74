"""The LM steps, port of ``repro/launch/steps.py``: the training step
(``:21-98``) for one microbatch (loss, gradients, warm-up cosine learning
rate and an AdamW update with weight decay 0.1 and the chosen moment
dtype), and the decoder's decode step (``:124-142``).  Microbatching and
the prefill step wait for their caller (the dry run); the
encoder-decoder's decode step waits for whisper."""
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
    the step's key (it seeds the int8 moments' stochastic rounding)."""
    adam_cfg = AdamWConfig(weight_decay=0.1, moment_dtype=opts.moment_dtype)
    lr_fn = warmup_cosine(opts.lr, opts.warmup, opts.total_steps)

    def train_step(params, opt_state, batch, rng):
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        paths, leaves = zip(*tree.leaves(params))
        for p in leaves:  # restored leaves come back as plain tensors
            p.requires_grad_(True)
        loss, _ = model.loss(params, tokens, batch["targets"], positions)
        by_path = dict(zip(paths, torch.autograd.grad(loss, leaves)))
        lr = lr_fn(int(opt_state["step"]))
        adamw.update(params, opt_state, tree.rebuild(params, lambda path, _: by_path[path]),
                     lr, adam_cfg, rng)
        return params, opt_state, {"loss": loss.detach(), "lr": lr}

    return train_step, adam_cfg


def make_decode_step(model):
    """One new token against a filled KV cache: ``decode_step(params,
    cache, batch) -> (logits [B, V], cache)`` with ``batch`` holding
    ``token`` [B, 1] and ``pos``, the absolute position.  The cache is
    written in place (``DecoderLM.decode_step``)."""

    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch["token"], batch["pos"])

    return decode_step
