"""AdamW with optional compressed moments (bf16 / int8), port of
``repro/optim/adamw.py`` (``:19-121``).

The update is the reference's, not ``torch.optim.Adam``'s: bias correction
``1 - b ** step`` in float32 and ``mh / (sqrt(vh) + eps)`` with
``mh = m / bc1``, ``vh = v / bc2``, in float32 whatever the parameter's
dtype.  Parameters, float32 moments and the state are updated in place
(the reference returns new arrays; in place saves the copies); a bf16 or
int8 moment is replaced by its new stored form.

``params`` is a tree (``repro_torch.tree``): a flat dict, or the nested
dicts and lists of an LM.  The moment trees mirror it; an int8 moment is
``{"q": int8, "s": float32 scale}`` as in the reference, so checkpoints of
either package restore in the other.  The int8 first moment is rounded
stochastically; its noise comes from a ``torch.Generator`` on the
parameter's device seeded from ``rng`` (the step's integer key, a
reference-shaped uint32[2] leaf) and the leaf's index, so a run replays
bit for bit, but the draws are not ``jax.random``'s.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import tree

MOMENT_DTYPES = ("fp32", "bf16", "int8")


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    moment_dtype: str = "fp32"  # fp32 | bf16 | int8


def init(params, cfg: AdamWConfig = AdamWConfig()) -> dict:
    if cfg.moment_dtype not in MOMENT_DTYPES:
        raise ValueError(f"moment_dtype {cfg.moment_dtype!r} not in {MOMENT_DTYPES}")

    def zeros(_, p):
        if cfg.moment_dtype == "int8":
            return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                    "s": torch.zeros((), dtype=torch.float32, device=p.device)}
        dt = torch.bfloat16 if cfg.moment_dtype == "bf16" else torch.float32
        return torch.zeros_like(p, dtype=dt)

    return {"step": 0, "m": tree.rebuild(params, zeros), "v": tree.rebuild(params, zeros)}


def _leaf_seed(rng, index: int) -> int:
    """A 63-bit seed for leaf ``index`` from the step's key ``rng`` (two
    unsigned 32-bit words)."""
    words = [int(w) for w in np.asarray(rng, np.uint64).reshape(-1)]
    s = np.random.SeedSequence(words + [index]).generate_state(2, np.uint32)
    return (int(s[0]) << 31 | int(s[1])) & ((1 << 63) - 1)


def _store(x: torch.Tensor, dtype: str, generator: torch.Generator | None = None,
           stochastic: bool = False):
    """float32 moment -> its stored form; ``stochastic``: int8 codes
    rounded with noise drawn from ``generator`` (None on the ``meta``
    device, which has no generator and draws nothing)."""
    if dtype == "bf16":
        return x.to(torch.bfloat16)
    # 0-d divisors: CUDA divides by a Python scalar through its reciprocal
    scale = torch.clamp(x.abs().max(), min=1e-30) / torch.full((), 127.0, device=x.device)
    y = x / scale
    if stochastic:  # the first moment
        y = torch.floor(y + torch.rand(y.shape, generator=generator, dtype=torch.float32,
                                       device=y.device))
    else:
        y = torch.round(y)
    return {"q": torch.clamp(y, -127, 127).to(torch.int8), "s": scale}


def _load(x, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return x["q"].to(torch.float32) * x["s"]
    return x.to(torch.float32)


def bias_corrections(step: int, cfg: AdamWConfig = AdamWConfig()) -> tuple[float, float]:
    """``1 - b1 ** step`` and ``1 - b2 ** step`` in float32, as floats."""
    s = torch.tensor(float(step), dtype=torch.float32)
    return tuple(float(1.0 - torch.pow(torch.tensor(b, dtype=torch.float32), s))
                 for b in (cfg.b1, cfg.b2))


@torch.no_grad()
def update(params, state: dict, grads, lr: float | torch.Tensor,
           cfg: AdamWConfig = AdamWConfig(), rng=None, *,
           corrections: tuple[torch.Tensor, torch.Tensor] | None = None) -> None:
    """One AdamW step on every leaf of ``params`` (in place, as is
    ``state``).  ``grads`` has ``params``' structure; ``rng`` seeds the int8
    mode's stochastic rounding (default: the key ``[0, 0]``).

    ``corrections``: the two bias corrections as 0-d float32 tensors on the
    parameters' device, with ``lr`` one as well (fp32 moments only).  The
    step then reads all three when it runs, not when it is queued, and
    leaves ``state["step"]`` to the caller: a captured step replays with
    the values filled in before each replay."""
    mode = cfg.moment_dtype
    if corrections is None:
        state["step"] = int(state["step"]) + 1
        bcs = bias_corrections(state["step"], cfg)
    elif mode != "fp32":
        raise ValueError(f"device-scalar corrections need fp32 moments, not {mode!r}")
    if rng is None:
        rng = np.zeros(2, np.uint32)
    for i, (path, p) in enumerate(tree.leaves(params)):
        # 0-d device tensors (filled, not copied: no host sync), because
        # CUDA divides by a Python scalar through its reciprocal
        bc1, bc2 = corrections or (torch.full((), v, dtype=torch.float32, device=p.device)
                                   for v in bcs)
        g = tree.get(grads, path).to(torch.float32)
        if mode == "fp32":
            m, v = tree.get(state["m"], path), tree.get(state["v"], path)
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        else:
            m = cfg.b1 * _load(tree.get(state["m"], path), mode) + (1 - cfg.b1) * g
            v = cfg.b2 * _load(tree.get(state["v"], path), mode) + (1 - cfg.b2) * g * g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        if cfg.weight_decay:
            upd = upd + cfg.weight_decay * pf
        if p.dtype == torch.float32:
            p.sub_(lr * upd)
        else:
            p.copy_(pf - lr * upd)
        if mode != "fp32":
            gen = None
            if mode == "int8" and not p.is_meta:
                gen = torch.Generator(device=p.device).manual_seed(_leaf_seed(rng, i))
            tree.put(state["m"], path, _store(m, mode, gen, stochastic=True))
            tree.put(state["v"], path, _store(v, mode))
