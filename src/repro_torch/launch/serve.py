"""Serving driver, port of ``repro/launch/serve.py``:
``python -m repro_torch.launch.serve --arch <id> [--reduced] [--device cpu]``.

Batched greedy decoding against the decode caches (ring-buffer and latent
KV caches, recurrent states): the prompt (drawn from
``np.random.default_rng(seed)``, as the reference draws it) is
teacher-forced one decode step a token, then each step's argmax is fed
back.  An encoder-decoder's frame embeddings are drawn next from the same
generator and encoded once; every step reads the encoder's output.  The
decode step runs eagerly, its ops launched one by one (the reference jits
it); positions and the prompt live on the device and the generated tokens
stay there until the end, so the loop itself waits for the device nowhere.
``--device cuda`` (the default) needs a card; use ``--reduced --device
cpu`` here.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import ARCH_IDS, build_model, get_family
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.steps import make_decode_step


def generate(step, params, cache, prompt: torch.Tensor, gen_len: int, enc_out=None):
    """Greedy decoding: ``prompt`` [B, P] int32 on the model's device ->
    (generated tokens [B, gen_len] int32, the last step's logits [B, V]).
    ``cache`` is written in place; ``enc_out`` goes into every step's
    batch (an encoder-decoder's)."""
    B, P = prompt.shape
    n_steps = P + gen_len - 1
    positions = torch.arange(n_steps, dtype=torch.int32, device=prompt.device)
    extra = {} if enc_out is None else {"enc_out": enc_out}
    tok = prompt[:, :1]
    out = []
    for pos in range(n_steps):
        logits, cache = step(params, cache, {"token": tok, "pos": positions[pos], **extra})
        if pos + 1 < P:
            tok = prompt[:, pos + 1:pos + 2]  # teacher-forced prompt
        else:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            out.append(tok)
    return torch.cat(out, dim=1), logits


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, *, params=None):
    """Runs the driver; returns the generated tokens [batch, gen_len] as a
    numpy int32 array.  ``params`` replaces the seeded init (a parameter
    tree on the chosen device, e.g. carried across from the reference)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="granite-3-8b", choices=list(ARCH_IDS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--ctx", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run goes (cuda: the card, which must exist)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device available (use --device cpu)")
    device = resolve_device(None if args.device == "cuda" else "cpu")

    model, cfg = build_model(args.arch, reduced=args.reduced, device=device)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    cache = model.init_cache(args.batch, args.ctx, dtype=cfg.compute_dtype)
    step = make_decode_step(model)

    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)
    prompt = torch.from_numpy(prompt).to(device)
    n_steps = args.prompt_len + args.gen_len - 1
    enc_out, enc_said = None, ""
    with torch.no_grad():
        if get_family(args.arch) == "encdec":
            model.check_positions(n_steps)
            feats = rng.normal(size=(args.batch, cfg.enc_seq, cfg.d_model))
            feats = torch.from_numpy(feats).to(cfg.compute_dtype).to(device)
            sync(device)
            t0 = time.perf_counter()
            enc_out = model.encode(params, feats)
            sync(device)
            enc_said = f" encode_s={time.perf_counter() - t0:.4f}"
        sync(device)
        t0 = time.perf_counter()
        gen, logits = generate(step, params, cache, prompt, args.gen_len, enc_out)
        gen = gen.cpu().numpy()  # waits for the device
        dt = time.perf_counter() - t0
    kv_bytes = sum(t.numel() * t.element_size() for _, t in tree.leaves(cache))
    peak = (f" device_peak_bytes={torch.cuda.max_memory_allocated(device)}"
            if device.type == "cuda" else "")
    print(f"arch={cfg.name} generated shape={gen.shape} tokens/s={args.batch * n_steps / dt:,.1f} "
          f"ms/step={dt / n_steps * 1e3:.4f} kv_cache_bytes={kv_bytes}{enc_said}{peak} "
          f"device={device}")
    print("sample:", gen[0][:16].tolist())
    if not bool(torch.isfinite(logits).all()):
        raise FloatingPointError("non-finite logits")
    return gen


if __name__ == "__main__":
    main()
