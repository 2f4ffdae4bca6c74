"""Grouped-query attention, port of ``repro/models/attention.py``
(``:44-272``): full causal attention without a cache, the path of the dense
decoders (granite, yi, llama3) in training.

Attention has no Pallas kernel in the reference, so this is plain torch
and mirrors the reference's blockwise einsum, mask and float32 softmax;
fused attention is later work.  Sliding and chunked masks, MLA, qk-norm,
M-RoPE, softcapping and decode caches are not ported yet:
``models/decoder.py`` refuses a configuration that uses them.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models.common import apply_rope, normal_init

MASK_CAUSAL, MASK_SLIDING, MASK_CHUNKED, MASK_BIDIR = 0, 1, 2, 3


@dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_model: int
    rope_theta: float = 1e4
    # the reference's other mechanisms; set, they are refused (not ported)
    qk_norm: bool = False
    mla: Optional[object] = None
    mrope_sections: Optional[tuple[int, ...]] = None
    mrope_theta: float = 1e6
    softcap: float = 0.0


def init_gqa_params(cfg: AttnConfig, *, generator: torch.Generator,
                    dtype=torch.float32) -> dict:
    """Normal weights scaled by fan-in (``common.normal_init``)."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    normal = functools.partial(normal_init, generator=generator, dtype=dtype)
    s = d ** -0.5
    return {"wq": normal((d, H, hd), s), "wk": normal((d, K, hd), s),
            "wv": normal((d, K, hd), s), "wo": normal((H, hd, d), (H * hd) ** -0.5)}


def _mask_logits(scores: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
                 mask_mode: int) -> torch.Tensor:
    """scores: [..., Lq, Lk]; q_pos: [Lq]; k_pos: [Lk]."""
    if mask_mode != MASK_CAUSAL:
        raise NotImplementedError(f"attention mask mode {mask_mode} is not ported yet")
    allow = k_pos[None, :] <= q_pos[:, None]
    return torch.where(allow, scores, torch.full((), -1e30, dtype=scores.dtype,
                                                 device=scores.device))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_positions: torch.Tensor,
           k_positions: torch.Tensor, *, mask_mode: int = MASK_CAUSAL,
           q_block: int = 512) -> torch.Tensor:
    """GQA attention, blockwise over queries (the mask built per block from
    positions, float32 softmax).  q [B, Lq, H, D], k [B, Lk, K, D],
    v [B, Lk, K, Dv] -> [B, Lq, H, Dv] in q's dtype."""
    B, Lq, H, D = q.shape
    K, Dv = k.shape[2], v.shape[3]
    G = H // K  # query heads per kv head
    scale = D ** -0.5
    qg = q.reshape(B, Lq, K, G, D)
    bq = min(q_block, Lq)
    if Lq % bq != 0:
        bq = Lq  # irregular sizes: one block
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    outs = []
    for i in range(0, Lq, bq):
        s = torch.einsum("bqkgd,bskd->bkgqs", qg[:, i:i + bq].to(torch.float32), kf) * scale
        s = _mask_logits(s, q_positions[i:i + bq], k_positions, mask_mode)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", p, vf))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Lq, H, Dv).to(q.dtype)


def gqa_attention(params: dict, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor, *,
                  mask_mode: int = MASK_CAUSAL, rope_on: bool = True,
                  rope_theta: float | None = None) -> torch.Tensor:
    """Self-attention over x [B, S, d] at positions [S] -> [B, S, d]."""
    theta = cfg.rope_theta if rope_theta is None else rope_theta
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"])
    k = torch.einsum("bsd,dke->bske", x, params["wk"])
    v = torch.einsum("bsd,dke->bske", x, params["wv"])
    if rope_on:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    out = attend(q, k, v, positions, positions, mask_mode=mask_mode)
    return torch.einsum("bshe,hed->bsd", out, params["wo"])
