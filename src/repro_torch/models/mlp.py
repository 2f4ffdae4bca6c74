"""The dense SwiGLU feed-forward block, port of ``repro/models/mlp.py``
(``:31-54``).  MoE and the GELU MLP are not ported yet
(``models/decoder.py`` refuses them)."""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models.common import normal_init


def init_mlp_params(d_model: int, d_ff: int, *, generator: torch.Generator,
                    dtype=torch.float32) -> dict:
    """SwiGLU weights, normal scaled by fan-in (``common.normal_init``)."""
    normal = functools.partial(normal_init, generator=generator, dtype=dtype)
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    return {"w_up": normal((d_model, d_ff), s_in), "w_down": normal((d_ff, d_model), s_out),
            "w_gate": normal((d_model, d_ff), s_in)}


def apply_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """silu(x W_gate) * (x W_up) W_down; x [B, S, d]."""
    h = F.silu(torch.einsum("bsd,df->bsf", x, params["w_gate"]))
    h = h * torch.einsum("bsd,df->bsf", x, params["w_up"])
    return torch.einsum("bsf,fd->bsd", h, params["w_down"])
