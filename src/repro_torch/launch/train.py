"""Training driver, port of ``repro/launch/train.py``:
``python -m repro_torch.launch.train --arch <id> [--reduced] [--device cpu]``.

Builds the architecture, the deterministic token pipeline and the train
step, and runs it under ``ResilientLoop`` (heartbeats, async checkpoints,
restore on failure).  The loop state is ``(params, opt_state, rng)`` in
the reference's tree layout (``rng`` a uint32[2] key on the host), so
``CheckpointManager`` restores a checkpoint written by either driver.
The port's keys come from numpy's ``SeedSequence``, not ``jax.random``.

On the card the run is deterministic (``torch.use_deterministic_algorithms``
and a fixed cuBLAS workspace), so a restarted run is bit-equal to a clean
one, as on the CPU.  ``--device cuda`` (the default) needs a card; use
``--reduced --device cpu`` here (the full configs need a card's memory).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, build_model, get_family
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.steps import TrainOptions, make_train_step
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FailureInjector, HeartbeatMonitor, ResilientLoop


def prng_key(seed: int) -> torch.Tensor:
    """The reference's ``jax.random.PRNGKey(seed)`` leaf: uint32
    ``[seed >> 32, seed & 0xFFFFFFFF]``, on the host."""
    return torch.tensor([seed >> 32, seed & 0xFFFFFFFF], dtype=torch.uint32)


def split_key(rng: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(next key, this step's key) from a uint32[2] key, deterministically."""
    words = np.random.SeedSequence([int(w) for w in rng.numpy()]).generate_state(4, np.uint32)
    return torch.from_numpy(words[:2].copy()), torch.from_numpy(words[2:].copy())


def make_loop_step(step_fn):
    """``ResilientLoop``'s step over ``(params, opt_state, rng)``."""

    def loop_step(state, batch):
        params, opt_state, rng = state
        rng, sub = split_key(rng)
        params, opt_state, metrics = step_fn(params, opt_state, batch, sub)
        return (params, opt_state, rng), metrics

    return loop_step


@contextlib.contextmanager
def deterministic(device: torch.device):
    """Deterministic algorithms for the run on the card (cuBLAS reads its
    workspace setting when the process first uses it, so this comes before
    any CUDA work); the previous setting is restored after."""
    if device.type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="granite-3-8b", choices=list(ARCH_IDS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--moment-dtype", default="fp32", choices=list(adamw.MOMENT_DTYPES))
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--gwlz-ckpt-eb", type=float, default=None,
                    help="rel error bound for GWLZ-compressed checkpoints")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run goes (cuda: the card, which must exist)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device available (use --device cpu)")
    device = resolve_device(None if args.device == "cuda" else "cpu")

    with deterministic(device):
        model, cfg = build_model(args.arch, reduced=args.reduced, device=device)
        params = model.init(torch.Generator(device=device).manual_seed(args.seed))
        n_params = sum(p.numel() for _, p in tree.leaves(params))
        print(f"arch={cfg.name} params={n_params:,} device={device}", flush=True)

        opts = TrainOptions(lr=args.lr, warmup=max(args.steps // 10, 1),
                            total_steps=args.steps, moment_dtype=args.moment_dtype)
        step_fn, adam_cfg = make_train_step(model, cfg, opts)
        opt_state = adamw.init(params, adam_cfg)
        pipe = TokenPipeline(TokenPipelineConfig(cfg.vocab, args.batch, args.seq, seed=args.seed))
        mrope = cfg.attn is not None and cfg.attn.mrope_sections is not None
        encdec = get_family(args.arch) == "encdec"

        def batch_fn(step):
            """The step's tokens; M-RoPE's positions (every stream
            ``arange(seq)``) and an encoder-decoder's frame embeddings
            (float32 normals from ``default_rng(step)``, cast to the compute
            dtype), as the reference driver makes them."""
            batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(step).items()}
            if mrope:
                batch["positions"] = torch.arange(args.seq, dtype=torch.int32, device=device)[
                    None, None, :].expand(args.batch, 3, args.seq)
            if encdec:
                feats = np.random.default_rng(step).normal(
                    size=(args.batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
                batch["enc_feats"] = torch.from_numpy(feats).to(device, cfg.compute_dtype)
            return batch

        manager = CheckpointManager(args.ckpt_dir, gwlz_rel_eb=args.gwlz_ckpt_eb, device=device)
        monitor = HeartbeatMonitor(n_workers=1)
        injector = (FailureInjector({args.inject_failure_at})
                    if args.inject_failure_at is not None else None)
        loop = ResilientLoop(make_loop_step(step_fn), batch_fn, manager,
                             ckpt_every=args.ckpt_every)
        state = (params, opt_state, prng_key(args.seed + 1))
        t0 = time.time()
        state, metrics_log, restarts = loop.run(state, args.steps, injector=injector,
                                                monitor=monitor)
        losses = [float(m["loss"]) for m in metrics_log]
        dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    print(f"steps={args.steps} restarts={restarts} loss[0]={losses[0]:.3f} "
          f"loss[-1]={losses[-1]:.3f} tokens/s={toks/dt:,.0f} stragglers={monitor.stragglers()}")
    return losses


if __name__ == "__main__":
    main()
