"""Attention-free sequence mixers, port of ``repro/models/ssm.py``
(``:16-232``): RWKV6 (Finch) time and channel mix, and Mamba2 (SSD, a
scalar decay per head).

Both are recurrences with a state of fixed size.  The reference runs them
as a ``lax.scan`` of plain ``jnp`` over time; the port runs the same
float32 step as a loop over T of plain torch ops (a decode step, T = 1,
runs it once), so a fused scan kernel is later work.

A state passed in is the caller's decode cache: it is written in place
(``shift``, ``wkv``; ``conv``, ``ssm``) and returned, as the attention
caches are.  Without one the recurrence starts from zeros and the state it
ends with is returned in new tensors.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.common import normal_init
from repro_torch.models.spmd import einsum, reshape


@dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    head_dim: int = 64
    d_ff: int = 14336
    lora_mix: int = 32
    lora_decay: int = 64

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


@dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


# ---------------------------------------------------------------------------
# RWKV6 time mix + channel mix
# ---------------------------------------------------------------------------

_MIX_NAMES = ("r", "k", "v", "w", "g")


def init_rwkv6_params(cfg: RWKV6Config, *, generator: torch.Generator,
                      dtype=torch.float32) -> dict:
    """The reference's tree: token-shift mixes at 0.5, the mix and decay
    LoRAs, a zero decay bias and bonus, the five projections, the group
    norm's scale, and the channel mix."""
    d, r = cfg.d_model, cfg.lora_mix
    normal = functools.partial(normal_init, generator=generator, dtype=dtype)
    full = lambda shape, v: torch.full(shape, v, dtype=dtype, device=generator.device)
    s = d ** -0.5
    return {
        "mu_x": full((d,), 0.5),
        "mu": full((5, d), 0.5),
        "mix_w1": normal((d, 5 * r), s),
        "mix_w2": normal((5, r, d), r ** -0.5),
        "w0": full((d,), 0.0),  # decay bias (per channel)
        "decay_w1": normal((d, cfg.lora_decay), s),
        "decay_w2": normal((cfg.lora_decay, d), cfg.lora_decay ** -0.5),
        "u": full((cfg.n_heads, cfg.head_dim), 0.0),  # per-head bonus
        "wr": normal((d, d), s),
        "wk": normal((d, d), s),
        "wv": normal((d, d), s),
        "wg": normal((d, d), s),
        "wo": normal((d, d), s),
        "ln_out": full((d,), 1.0),  # per-head group norm scale
        # channel mix
        "cmix_r": full((d,), 0.5),
        "cmix_k": full((d,), 0.5),
        "cm_wr": normal((d, d), s),
        "cm_wk": normal((d, cfg.d_ff), s),
        "cm_wv": normal((cfg.d_ff, d), cfg.d_ff ** -0.5),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x: [B, T, d] -> the previous token's stream; ``prev`` [B, d] is the
    token before x (zeros where None)."""
    if prev is None:  # a zero row, then all but the last (DTensor has no rule for pad)
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    if x.shape[1] == 1:
        return prev[:, None]
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _scan(step, state: torch.Tensor, seq: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.scan`` over the leading (time) axis of each tensor of ``seq``:
    (final state, the step outputs stacked on axis 0)."""
    outs = []
    for t in range(seq[0].shape[0]):
        state, out = step(state, *(s[t] for s in seq))
        outs.append(out)
    return state, torch.stack(outs)


def rwkv6_time_mix(params: dict, cfg: RWKV6Config, x: torch.Tensor, state: dict | None):
    """x: [B, T, d]; state: {"shift": [B, d], "wkv": [B, H, hd, hd] float32}
    or None (zeros).  Returns (out [B, T, d], state)."""
    B, T, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    xs = _token_shift(x, None if state is None else state["shift"])
    xx = xs - x
    xxx = x + xx * params["mu_x"]
    mix = torch.tanh(einsum("btd,dr->btr", xxx, params["mix_w1"]))
    mix = reshape(mix, B, T, 5, mix.shape[-1] // 5)
    dmu = einsum("btfr,frd->fbtd", mix, params["mix_w2"])  # [5, B, T, d]
    feeds = {n: x + xx * (params["mu"][i] + dmu[i]) for i, n in enumerate(_MIX_NAMES)}

    r = reshape(einsum("btd,de->bte", feeds["r"], params["wr"]), B, T, H, hd)
    k = reshape(einsum("btd,de->bte", feeds["k"], params["wk"]), B, T, H, hd)
    v = reshape(einsum("btd,de->bte", feeds["v"], params["wv"]), B, T, H, hd)
    g = F.silu(einsum("btd,de->bte", feeds["g"], params["wg"]))
    # data-dependent decay in (0, 1): w = exp(-exp(w0 + lora(x_w)))
    dw = einsum("btr,rd->btd", torch.tanh(
        einsum("btd,dr->btr", feeds["w"], params["decay_w1"])), params["decay_w2"])
    w = reshape(torch.exp(-torch.exp(params["w0"] + dw)), B, T, H, hd)
    u = params["u"][None, :, :, None]

    def step(s, rt, kt, vt, wt):  # [B, H, hd] each
        kv = kt[..., :, None] * vt[..., None, :]  # outer product [B, H, k, v]
        out = einsum("bhk,bhkv->bhv", rt, s + u * kv)
        return s * wt[..., None] + kv, out  # the decay runs along the key dim

    wkv0 = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
            if state is None else state["wkv"])
    seq = tuple(t.transpose(0, 1).to(torch.float32) for t in (r, k, v, w))
    new_wkv, outs = _scan(step, wkv0, seq)
    out = reshape(outs.transpose(0, 1), B, T, d).to(x.dtype)
    # per-head group norm (the population variance, computed in float32
    # and rounded to x's dtype, as jnp's mean and var), then gate and project
    out = reshape(out, B, T, H, hd)
    o32 = out.to(torch.float32)
    mu_o = o32.mean(-1, keepdim=True)
    var_o = ((o32 - mu_o) ** 2).mean(-1, keepdim=True).to(out.dtype)
    out = reshape((out - mu_o.to(out.dtype)) * torch.rsqrt(var_o + 1e-5), B, T, d)
    out = out * params["ln_out"]
    out = einsum("btd,de->bte", out * g, params["wo"])
    if state is None:
        return out, {"shift": x[:, -1], "wkv": new_wkv}
    state["shift"].copy_(x[:, -1])
    state["wkv"].copy_(new_wkv)
    return out, state


def rwkv6_channel_mix(params: dict, cfg: RWKV6Config, x: torch.Tensor,
                      state: torch.Tensor | None):
    """x: [B, T, d]; state: the previous token [B, d] or None (zeros).
    Returns (out [B, T, d], state)."""
    xs = _token_shift(x, state)
    xx = xs - x
    xr = x + xx * params["cmix_r"]
    xk = x + xx * params["cmix_k"]
    rr = torch.sigmoid(einsum("btd,de->bte", xr, params["cm_wr"]))
    kk = torch.square(torch.relu(einsum("btd,df->btf", xk, params["cm_wk"])))
    out = rr * einsum("btf,fd->btd", kk, params["cm_wv"])
    if state is None:
        return out, x[:, -1]
    state.copy_(x[:, -1])
    return out, state


# ---------------------------------------------------------------------------
# Mamba2 (SSD, scalar-per-head decay)
# ---------------------------------------------------------------------------


def init_mamba2_params(cfg: Mamba2Config, *, generator: torch.Generator,
                       dtype=torch.float32) -> dict:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    normal = functools.partial(normal_init, generator=generator, dtype=dtype)
    full = lambda n, v: torch.full((n,), v, dtype=dtype, device=generator.device)
    conv_ch = di + 2 * N
    return {
        "w_in": normal((d, 2 * di + 2 * N + H), d ** -0.5),
        "conv_w": normal((cfg.conv_width, conv_ch), 0.1),
        "conv_b": full(conv_ch, 0.0),
        "A_log": full(H, 0.0),
        "D": full(H, 1.0),
        "dt_bias": full(H, 0.0),
        "norm": full(di, 1.0),
        "w_out": normal((di, d), di ** -0.5),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: torch.Tensor | None):
    """x: [B, T, C]; w: [W, C] depthwise; state: [B, W-1, C], the inputs
    before x (zeros where None).  Returns (silu(conv + b), the last W-1
    inputs); the taps are summed in the reference's order, in x's dtype."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return F.silu(out + b), xp[:, -(W - 1):]


def mamba2_mix(params: dict, cfg: Mamba2Config, x: torch.Tensor, state: dict | None):
    """x: [B, T, d]; state: {"conv": [B, W-1, C], "ssm": [B, H, P, N]
    float32} or None (zeros).  Returns (out [B, T, d], state)."""
    B, T, d = x.shape
    di, N, H, Pdim = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    zxbcdt = einsum("btd,de->bte", x, params["w_in"])
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    xbc, conv_state = _causal_conv1d(xbc, params["conv_w"], params["conv_b"],
                                     None if state is None else state["conv"])
    xin, Bmat, Cmat = torch.split(xbc, [di, N, N], dim=-1)
    dt = F.softplus(dt + params["dt_bias"])  # [B, T, H]
    A = -torch.exp(params["A_log"].to(torch.float32))  # [H], negative
    xh = reshape(xin, B, T, H, Pdim)

    def step(s, xt, bt, ct, dtt):  # [B, H, P], [B, N], [B, N], [B, H]
        decay = torch.exp(dtt * A)  # [B, H]
        upd = (xt * dtt[..., None])[..., None] * bt[:, None, None, :]  # [B, H, P, N]
        s = s * decay[..., None, None] + upd
        return s, einsum("bhpn,bn->bhp", s, ct)

    ssm0 = (torch.zeros((B, H, Pdim, N), dtype=torch.float32, device=x.device)
            if state is None else state["ssm"])
    seq = tuple(t.transpose(0, 1).to(torch.float32) for t in (xh, Bmat, Cmat, dt))
    new_ssm, ys = _scan(step, ssm0, seq)
    y = ys.transpose(0, 1)  # [B, T, H, P]
    y = y + params["D"][None, None, :, None] * xh.to(torch.float32)
    y = reshape(y, B, T, di).to(x.dtype)
    # gated RMSNorm (scaled by ``norm`` itself, not 1 + norm), then out-proj
    y = y * F.silu(z)
    y32 = y.to(torch.float32)
    y = (y32 * torch.rsqrt(torch.mean(y32 * y32, -1, keepdim=True) + 1e-6)).to(y.dtype)
    out = einsum("bte,ed->btd", y * params["norm"], params["w_out"])
    if state is None:
        return out, {"conv": conv_state, "ssm": new_ssm}
    state["conv"].copy_(conv_state)
    state["ssm"].copy_(new_ssm)
    return out, state
