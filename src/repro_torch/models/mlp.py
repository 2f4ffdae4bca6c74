"""Feed-forward blocks, port of ``repro/models/mlp.py`` (``:19-131``): the
dense SwiGLU and GELU MLPs and the capacity-based MoE (top-k routing with
a per-expert capacity, the slot in an expert by a cumsum over the dispatch
order, dense [E, C, d] expert products, a combine weighted by the router).
No configuration pairs MoE with GELU, so the MoE is SwiGLU only."""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.common import normal_init
from repro_torch.models.spmd import RowBlocks, einsum


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden dim
    n_shared: int = 0               # shared (always-on) experts
    shared_d_ff: int = 0
    router: str = "softmax"         # softmax | sigmoid (deepseek-v3)
    capacity_factor: float = 1.25
    first_dense: int = 0            # leading dense layers (deepseek: 3)
    aux_loss_coef: float = 0.001


def init_mlp_params(d_model: int, d_ff: int, act: str, *,
                    generator: torch.Generator, dtype=torch.float32) -> dict:
    """MLP weights, normal scaled by fan-in (``common.normal_init``); the
    SwiGLU gate ``w_gate`` only where ``act`` is "silu"."""
    normal = functools.partial(normal_init, generator=generator, dtype=dtype)
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    p = {"w_up": normal((d_model, d_ff), s_in), "w_down": normal((d_ff, d_model), s_out)}
    if act == "silu":
        p["w_gate"] = normal((d_model, d_ff), s_in)
    return p


def apply_mlp(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """x [B, S, d] -> "silu": silu(x W_gate) * (x W_up) W_down; "gelu":
    gelu(x W_up) W_down with ``jax.nn.gelu``'s default, the tanh form."""
    if act == "silu":
        h = F.silu(einsum("bsd,df->bsf", x, params["w_gate"]))
        h = h * einsum("bsd,df->bsf", x, params["w_up"])
    elif act == "gelu":
        h = F.gelu(einsum("bsd,df->bsf", x, params["w_up"]), approximate="tanh")
    else:
        raise ValueError(act)
    return einsum("bsf,fd->bsd", h, params["w_down"])


def init_moe_params(d_model: int, cfg: MoEConfig, *, generator: torch.Generator,
                    dtype=torch.float32) -> dict:
    """A float32 router, SwiGLU experts stacked on a leading [E] axis, and
    the shared expert where ``cfg.n_shared``.  Each leaf is cast as it is
    drawn, so the float32 draw of one expert tensor is the transient."""
    normal = functools.partial(normal_init, generator=generator, dtype=dtype)
    E, Fd = cfg.n_experts, cfg.d_ff
    s_in, s_out = d_model ** -0.5, Fd ** -0.5
    p = {"router": normal_init((d_model, E), s_in, generator=generator, dtype=torch.float32),
         "we_up": normal((E, d_model, Fd), s_in),
         "we_down": normal((E, Fd, d_model), s_out),
         "we_gate": normal((E, d_model, Fd), s_in)}
    if cfg.n_shared:
        p["shared"] = init_mlp_params(d_model, cfg.shared_d_ff or cfg.d_ff, "silu",
                                      generator=generator, dtype=dtype)
    return p


def _route(logits: torch.Tensor, cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [T, E] -> (weights [T, k], expert ids [T, k])."""
    if cfg.router == "sigmoid":  # deepseek-v3: sigmoid scores, normalised top-k
        w, idx = torch.topk(torch.sigmoid(logits), cfg.top_k, dim=-1)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    else:
        w, idx = torch.topk(torch.softmax(logits, dim=-1), cfg.top_k, dim=-1)
    return w, idx


def apply_moe(params: dict, x: torch.Tensor, cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (out [B, S, d], the Switch load-balance aux loss, a
    float32 scalar).  A (token, k) pair past its expert's capacity is
    dropped (it adds nothing).

    Every kept pair owns one slot of the [E, cap] buffer, so the dispatch
    is an indexed assignment onto zeros (``index_put_``), deterministic on
    the card; the dropped pairs all go to one trash row, which is cut off
    unread.

    On DTensors each rank routes, dispatches and combines the tokens of
    its batch rows into its own [E, cap] buffer, cap from its own token
    count (capacity per data shard, as GShard's; one rank: the same
    buffer), and only the expert products run sharded (experts on
    ``model``): DTensor has no rule for the dispatch's indexed writes.  The
    aux loss is then the mean of the shards' own."""
    blocks = RowBlocks(x)
    x_in, x = x, blocks.local(x)
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E, k = cfg.n_experts, cfg.top_k
    cap = int(max(1, round(T * k * cfg.capacity_factor / E)))  # Python's round, as the reference

    logits = xt.to(torch.float32) @ blocks.param(params["router"])
    w, idx = _route(logits, cfg)  # [T, k]

    flat_e = idx.reshape(-1)  # [T*k], the (t, k) dispatch order
    onehot = F.one_hot(flat_e, E).to(torch.int32)  # [T*k, E]
    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    f = onehot.sum(0).to(torch.float32) / (T * k)
    probs = torch.softmax(logits, dim=-1)
    aux = E * torch.sum(f * probs.mean(0)) * cfg.aux_loss_coef

    # the slot in an expert: an exclusive cumsum over the dispatch order
    cum = torch.cumsum(onehot, dim=0) - onehot
    pos_in_e = torch.gather(cum, 1, flat_e[:, None])[:, 0]
    keep = pos_in_e < cap
    wflat = w.reshape(-1) * keep  # dropped pairs contribute nothing
    slot = torch.where(keep, flat_e * cap + pos_in_e, E * cap)  # overflow -> trash row
    buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot,), xt.repeat_interleave(k, dim=0))
    xe = blocks.wrap(buf[:-1].reshape(E, cap, d), dim=1)

    h = F.silu(einsum("ecd,edf->ecf", xe, params["we_gate"]))
    h = h * einsum("ecd,edf->ecf", xe, params["we_up"])
    ye = blocks.local(einsum("ecf,efd->ecd", h, params["we_down"]), dim=1)  # [E, cap, d]

    # gather back: each (t, k) reads its slot
    ytk = ye.reshape(E * cap, d)[torch.clamp(slot, max=E * cap - 1)]
    ytk = torch.where(keep[:, None], ytk, torch.zeros((), dtype=ytk.dtype, device=ytk.device))
    out = blocks.wrap((ytk * wflat[:, None]).reshape(T, k, d).sum(1).reshape(B, S, d))
    if "shared" in params:
        out = out + apply_mlp(params["shared"], x_in, "silu")
    return out.to(x.dtype), blocks.wrap(aux, dim=None)
