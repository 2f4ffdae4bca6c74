"""AdamW with float32 moments, port of ``repro/optim/adamw.py`` (``:19-121``).

The update is the reference's, not ``torch.optim.Adam``'s: bias correction
``1 - b ** step`` in float32 and ``mh / (sqrt(vh) + eps)`` with
``mh = m / bc1``, ``vh = v / bc2``.  Parameters and moments are updated in
place (the reference returns new arrays; in place saves the copies).  The
bf16/int8 moment modes are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    moment_dtype: str = "fp32"


def init(params: dict, cfg: AdamWConfig = AdamWConfig()) -> dict:
    if cfg.moment_dtype != "fp32":
        raise NotImplementedError(f"moment_dtype {cfg.moment_dtype!r} is not ported yet")
    return {"step": 0,
            "m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}}


@torch.no_grad()
def update(params: dict, state: dict, grads: dict, lr: float,
           cfg: AdamWConfig = AdamWConfig()) -> None:
    """One AdamW step on every leaf of ``params`` (in place, as is ``state``)."""
    state["step"] += 1
    step = torch.tensor(float(state["step"]), dtype=torch.float32)
    bcs = [float(1.0 - torch.pow(torch.tensor(b, dtype=torch.float32), step))
           for b in (cfg.b1, cfg.b2)]
    for k, p in params.items():
        # 0-dim device tensors (filled, not copied: no host sync), because
        # CUDA divides by a Python scalar through its reciprocal
        bc1, bc2 = (torch.full((), v, dtype=torch.float32, device=p.device) for v in bcs)
        g = grads[k].to(torch.float32)
        m, v = state["m"][k], state["v"][k]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay:
            upd = upd + cfg.weight_decay * p
        p.sub_(lr * upd)
