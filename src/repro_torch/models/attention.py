"""Attention, port of ``repro/models/attention.py`` (``:35-352``):
blockwise GQA over the four mask modes (full causal, sliding window,
chunked local, bidirectional) with logit softcapping and the banded
O(S·w) prefill of sliding and chunked layers; qk-norm; the decode path
against a ring-buffer KV cache; and MLA (deepseek-v3) with its latent
cache and absorbed decode.

Attention has no Pallas kernel in the reference, so this is plain torch
and mirrors the reference's einsums, masks and float32 softmax; a fused
kernel is later work.  ``gqa_attention`` also covers M-RoPE (qwen2-vl)
and cross-attention over an encoder's output (whisper).

Decode caches are updated in place: a cache passed to ``gqa_attention``
or ``mla_attention`` is written and returned, and the caller carries the
returned one on (the reference returns a fresh array; the values are the
same).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models.common import apply_mrope, apply_rope, normal_init, rms_norm
from repro_torch.models.spmd import (ContiguousGrad, all_reduce_over, einsum, local_block,
                                     settled, whole)

MASK_CAUSAL, MASK_SLIDING, MASK_CHUNKED, MASK_BIDIR = 0, 1, 2, 3
_UNWRITTEN = 1 << 30  # the position of a ring slot not written yet: in the future


@dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128


@dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_model: int
    rope_theta: float = 1e4
    qk_norm: bool = False
    mla: Optional[MLAConfig] = None
    # M-RoPE (qwen2-vl): half-dim sections of the t, h, w position streams
    mrope_sections: Optional[tuple[int, ...]] = None
    mrope_theta: float = 1e6
    softcap: float = 0.0  # gemma-style logit softcapping (0 = off)


def init_gqa_params(cfg: AttnConfig, *, generator: torch.Generator,
                    dtype=torch.float32) -> dict:
    """Normal weights scaled by fan-in (``common.normal_init``); zero
    qk-norm scales where ``cfg.qk_norm``."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    normal = functools.partial(normal_init, generator=generator, dtype=dtype)
    s = d ** -0.5
    p = {"wq": normal((d, H, hd), s), "wk": normal((d, K, hd), s),
         "wv": normal((d, K, hd), s), "wo": normal((H, hd, d), (H * hd) ** -0.5)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=generator.device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=generator.device)
    return p


def init_mla_params(cfg: AttnConfig, *, generator: torch.Generator,
                    dtype=torch.float32) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    normal = functools.partial(normal_init, generator=generator, dtype=dtype)
    s = d ** -0.5
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=generator.device)
    return {
        "w_dq": normal((d, m.q_lora), s),
        "w_uq": normal((m.q_lora, H, m.nope_dim + m.rope_dim), m.q_lora ** -0.5),
        "w_dkv": normal((d, m.kv_lora), s),
        "w_kr": normal((d, m.rope_dim), s),
        "w_uk": normal((m.kv_lora, H, m.nope_dim), m.kv_lora ** -0.5),
        "w_uv": normal((m.kv_lora, H, m.v_dim), m.kv_lora ** -0.5),
        "wo": normal((H, m.v_dim, d), (H * m.v_dim) ** -0.5),
        "q_ln": zeros(m.q_lora),
        "kv_ln": zeros(m.kv_lora),
    }


# ---------------------------------------------------------------------------
# masked blockwise attention core
# ---------------------------------------------------------------------------


def _mask_logits(scores: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
                 mask_mode: int, window: int) -> torch.Tensor:
    """scores: [..., Lq, Lk]; q_pos: [Lq]; k_pos: [Lk]."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    causal = dk <= dq
    if mask_mode == MASK_BIDIR:
        return scores
    if mask_mode == MASK_CAUSAL:
        allow = causal
    elif mask_mode == MASK_SLIDING:
        allow = causal & (dk > dq - window)
    elif mask_mode == MASK_CHUNKED:
        allow = causal & (dk // window == dq // window)  # floor division, as jnp's
    else:
        raise ValueError(mask_mode)
    return torch.where(allow, scores, torch.full((), -1e30, dtype=scores.dtype,
                                                 device=scores.device))


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap else x


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_positions: torch.Tensor,
           k_positions: torch.Tensor, *, mask_mode: int = MASK_CAUSAL, window: int = 0,
           q_block: int = 512, softcap: float = 0.0, banded: bool = False) -> torch.Tensor:
    """GQA attention, blockwise over queries (the mask built per block from
    positions, float32 softmax).  q [B, Lq, H, D], k [B, Lk, K, D],
    v [B, Lk, K, Dv] -> [B, Lq, H, Dv] in q's dtype.

    ``banded=True`` (sliding or chunked layers over contiguous positions:
    prefill and training) lets each query block attend only to the
    ``window + block`` keys it can see, O(S·w) instead of O(S²); it applies
    where the reference's does: more than one block, ``window > 0`` and a
    multiple of the block."""
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        return _attend_sharded(q, k, v, q_positions, k_positions, mask_mode=mask_mode,
                               window=window, q_block=q_block, softcap=softcap, banded=banded)
    B, Lq, H, D = q.shape
    Lk, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // K  # query heads per kv head
    scale = D ** -0.5
    qg = q.reshape(B, Lq, K, G, D)
    bq = min(q_block, Lq)
    if Lq % bq != 0:
        bq = Lq  # irregular sizes: one block
    nb = Lq // bq
    use_band = (banded and nb > 1 and window > 0
                and mask_mode in (MASK_SLIDING, MASK_CHUNKED) and window % bq == 0)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    outs = []
    for i in range(0, Lq, bq):
        qpos_b = q_positions[i:i + bq]
        kb, vb, kpos_b = kf, vf, k_positions
        if use_band:
            # visible keys: [q0 - window + bq, q0 + bq) for sliding, the
            # containing chunk for chunked: a static-size kw slice
            kw = min(window + bq, Lk)
            q0 = qpos_b[0]
            if mask_mode == MASK_SLIDING:
                start = torch.clamp(q0 + bq - kw, 0, Lk - kw)
            else:
                start = torch.clamp((q0 // window) * window, 0, Lk - kw)
            kpos_b = start + torch.arange(kw, device=k.device)
            kb, vb = kf.index_select(1, kpos_b), vf.index_select(1, kpos_b)
        s = einsum("bqkgd,bskd->bkgqs", qg[:, i:i + bq].to(torch.float32), kb) * scale
        s = _softcap(s, softcap)
        s = _mask_logits(s, qpos_b, kpos_b, mask_mode, window)
        p = torch.softmax(s, dim=-1)
        outs.append(einsum("bkgqs,bskd->bqkgd", p, vb))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Lq, H, Dv).to(q.dtype)


def _attend_sharded(q, k, v, q_positions, k_positions, **kw):
    """:func:`attend` of DTensors, on this rank's shards: attention is
    independent per batch row and head, so a rank computes its rows and
    heads alone (the reference's SPMD program does the same).  Where k and v
    are sharded on the sequence (a flash-decode cache), the ranks that
    share a query combine their partial softmaxes (:func:`_attend_seq_sharded`).
    k and v follow q's batch rows; with q's heads sharded and the kv heads
    whole, a rank takes the kv heads its query heads read (grouped query
    attention: head h reads kv head h // G)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    if not isinstance(k, DTensor):
        k, v = (DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
                for t in (k, v))
    q, k, v = settled(q), settled(k), settled(v)
    qpos, kpos = whole(q_positions), whole(k_positions)
    if any(p in (Shard(1), Shard(3)) for p in q.placements):
        raise ValueError(f"attention over queries sharded on sequence or depth: {q.placements}")
    if Shard(1) in k.placements:
        return _attend_seq_sharded(q, k, v, qpos, kpos, **kw)
    # k, v: q's batch rows (a local slice of whole rows), heads sharded
    # where q's are too, whole elsewhere
    want = [Shard(0) if qp == Shard(0) else Shard(2) if qp == kp == Shard(2) else Replicate()
            for qp, kp in zip(q.placements, k.placements)]
    k, v = (t.redistribute(mesh, want) for t in (k, v))
    H, K = q.shape[2], k.shape[2]
    G = H // K
    h0, hl = local_block(q, 2)
    slice_heads = [qp == Shard(2) and kp != Shard(2) for qp, kp in zip(q.placements, want)]
    grad_kv = [Partial() if sl else p for sl, p in zip(slice_heads, want)]
    kl, vl = (ContiguousGrad.apply(t.to_local(grad_placements=grad_kv)) for t in (k, v))
    if any(slice_heads):
        lo, hi = h0 // G, (h0 + hl - 1) // G + 1
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    out = attend(ContiguousGrad.apply(q.to_local()), kl, vl, qpos, kpos, **kw)
    B, Lq = q.shape[0], q.shape[1]
    return DTensor.from_local(out, mesh, q.placements, run_check=False,
                              shape=torch.Size((B, Lq, H, v.shape[3])),
                              stride=(Lq * H * v.shape[3], H * v.shape[3], v.shape[3], 1))


def _attend_seq_sharded(q, k, v, qpos, kpos, *, mask_mode, window, softcap, **_):
    """Attention over keys sharded on the sequence (flash decode): each rank
    scores its slots for every head, the ranks along the sequence's mesh
    dims combine the softmax's max, sum and weighted values (three
    all-reduces), and each keeps its query's heads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, q_placements = q.device_mesh, q.placements
    seq_dims = [i for i, p in enumerate(k.placements) if p == Shard(1)]
    # the query's heads whole (a decode step's query is small); its batch rows stay
    q_want = [Replicate() if i in seq_dims or p == Shard(2) else p
              for i, p in enumerate(q_placements)]
    q = q.redistribute(mesh, q_want)
    kv_want = [Shard(1) if i in seq_dims else Shard(0) if qp == Shard(0) else Replicate()
               for i, qp in enumerate(q_want)]
    k, v = (t.redistribute(mesh, kv_want) for t in (k, v))
    off, cl = local_block(k, 1)
    kpos = kpos[off:off + cl]
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    B, Lq, H, D = ql.shape
    K, Dv = kl.shape[2], vl.shape[3]
    qg = ql.reshape(B, Lq, K, H // K, D).to(torch.float32)
    s = einsum("bqkgd,bskd->bkgqs", qg, kl.to(torch.float32)) * D ** -0.5
    s = _mask_logits(_softcap(s, softcap), qpos, kpos, mask_mode, window)

    m = all_reduce_over(s.amax(dim=-1, keepdim=True), mesh, seq_dims, "max")
    p = torch.exp(s - m)
    den = all_reduce_over(p.sum(dim=-1), mesh, seq_dims)  # [B, K, G, Lq]
    num = all_reduce_over(einsum("bkgqs,bskd->bkgqd", p, vl.to(torch.float32)), mesh,
                          seq_dims)
    out = (num / den[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Lq, H, Dv).to(ql.dtype)
    return DTensor.from_local(out, mesh, q_want, run_check=False).redistribute(
        mesh, q_placements)


def _update_slice(buf: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> None:
    """``jax.lax.dynamic_update_slice`` of ``new`` into ``buf`` along axis
    1 at the device scalar ``start`` (clamped so that ``new`` fits), in
    place: no host sync."""
    from torch.distributed.tensor import DTensor

    S, C = new.shape[1], buf.shape[1]
    idx = torch.clamp(whole(start), 0, C - S).to(torch.int64) + torch.arange(
        S, device=buf.device)
    if not isinstance(buf, DTensor):
        buf.index_copy_(1, idx, new)
        return
    # a cache sharded on the sequence: the rank holding a slot writes it
    from torch.distributed.tensor import Replicate, Shard

    want = [Replicate() if p == Shard(1) else p for p in buf.placements]
    nl = new.redistribute(buf.device_mesh, want).to_local()
    off, cl = local_block(buf, 1)
    local = buf.to_local()
    li = idx - off
    inside = (li >= 0) & (li < cl)
    li = torch.clamp(li, 0, cl - 1)
    keep = local.index_select(1, li)
    local.index_copy_(1, li, torch.where(inside.view(1, -1, *([1] * (nl.ndim - 2))), nl, keep))


# ---------------------------------------------------------------------------
# GQA layer (full / sliding / chunked / bidirectional + ring-buffer cache)
# ---------------------------------------------------------------------------


def gqa_attention(params: dict, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor, *,
                  mask_mode: int = MASK_CAUSAL, window: int = 0, rope_on: bool = True,
                  rope_theta: float | None = None, cache: dict | None = None,
                  kv_source: torch.Tensor | None = None) -> tuple[torch.Tensor, dict | None]:
    """Attention of x [B, S, d] at positions [S] ([B, 3, S] under M-RoPE)
    -> (y [B, S, d], cache).

    With ``kv_source`` [B, Lk, d] (cross-attention) the keys and values
    come from it, unrotated, at key positions ``arange(Lk)``.  Under M-RoPE
    q and k are rotated per stream, and the causal order is the t
    stream's largest position over the batch.

    Cache layout: {"k": [B, C, K, D], "v": [B, C, K, D], "pos": int32
    scalar}, where C is the full context for global layers or the ring's
    size (= window) for sliding and chunked ones; ``pos`` is the absolute
    position of the first new token.  One new token goes to slot
    ``pos % C``, several to slot 0 (the reference's rule)."""
    theta = cfg.rope_theta if rope_theta is None else rope_theta
    src = x if kv_source is None else kv_source
    q = einsum("bsd,dhe->bshe", x, params["wq"])
    k = einsum("bsd,dke->bske", src, params["wk"])
    v = einsum("bsd,dke->bske", src, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if rope_on and kv_source is None and cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.mrope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.mrope_theta)
    elif rope_on and kv_source is None:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    pos1d = positions if positions.ndim == 1 else positions[:, 0, :].amax(dim=0)

    if cache is None:
        k_pos = (pos1d if kv_source is None
                 else torch.arange(k.shape[1], device=k.device))
        out = attend(q, k, v, pos1d, k_pos, mask_mode=mask_mode, window=window,
                     softcap=cfg.softcap, banded=True)
    else:
        # decode: write the new kv into the (ring) cache, attend over it
        C = cache["k"].shape[1]
        pos = cache["pos"]
        start = pos % C if k.shape[1] == 1 else torch.zeros_like(pos)
        _update_slice(cache["k"], k, start)
        _update_slice(cache["v"], v, start)
        # each slot's absolute position (% floors, as jnp's); unwritten
        # slots get a FUTURE position, so the causal test drops them (a past
        # sentinel would let zero vectors in as an attention sink)
        k_abs = pos - torch.remainder(pos - torch.arange(C, device=pos.device), C)
        k_positions = torch.where(k_abs < 0, _UNWRITTEN, k_abs)
        out = attend(q, cache["k"], cache["v"], pos1d, k_positions, mask_mode=mask_mode,
                     window=window, softcap=cfg.softcap)
        pos.add_(q.shape[1])
    return einsum("bshe,hed->bsd", out, params["wo"]), cache


def init_gqa_cache(batch: int, ctx: int, cfg: AttnConfig, *, window: int = 0,
                   dtype=torch.bfloat16, device=None) -> dict:
    C = window if window else ctx
    shape = (batch, C, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# MLA (deepseek-v3): latent KV cache, absorbed decode
# ---------------------------------------------------------------------------


def mla_attention(params: dict, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor, *,
                  cache: dict | None = None) -> tuple[torch.Tensor, dict | None]:
    """Multi-head latent attention.  The cache holds only ``c_kv`` and the
    shared rope key, kv_lora + rope_dim values a token.  Prefill expands
    the latents; decode attends in the latent space (w_uk absorbed into
    the query, w_uv applied after)."""
    m = cfg.mla
    H = cfg.n_heads
    cq = rms_norm(einsum("bsd,dr->bsr", x, params["w_dq"]), params["q_ln"])
    q = einsum("bsr,rhe->bshe", cq, params["w_uq"])  # e = nope + rope
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    c_kv = rms_norm(einsum("bsd,dr->bsr", x, params["w_dkv"]), params["kv_ln"])
    k_rope = einsum("bsd,de->bse", x, params["w_kr"])  # shared across heads
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    scale = (m.nope_dim + m.rope_dim) ** -0.5

    if cache is None:
        # prefill / training: expand the latents
        k_nope = einsum("bsr,rhe->bshe", c_kv, params["w_uk"])
        v = einsum("bsr,rhe->bshe", c_kv, params["w_uv"])
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_rope.shape[:2], H,
                                                                  m.rope_dim)], -1)
        q_full = torch.cat([q_nope, q_rope], -1)
        out = attend(q_full, k_full, v, positions, positions, mask_mode=MASK_CAUSAL)
        return einsum("bshe,hed->bsd", out, params["wo"]), None

    # decode: the absorbed form
    pos = cache["pos"]
    C = cache["c_kv"].shape[1]
    _update_slice(cache["c_kv"], c_kv, pos % C)
    _update_slice(cache["k_rope"], k_rope, pos % C)
    cc, cr = cache["c_kv"].to(torch.float32), cache["k_rope"].to(torch.float32)
    q_lat = einsum("bshe,rhe->bshr", q_nope, params["w_uk"])  # [B, S, H, r]
    s = einsum("bshr,btr->bhst", q_lat.to(torch.float32), cc)
    s = s + einsum("bshe,bte->bhst", q_rope.to(torch.float32), cr)
    valid = torch.arange(C, device=pos.device) <= pos
    s = torch.where(valid, s * scale, torch.full((), -1e30, device=s.device))
    p = torch.softmax(s, dim=-1)
    o_lat = einsum("bhst,btr->bshr", p, cc)  # [B, S, H, r]
    out = einsum("bshr,rhe->bshe", o_lat, params["w_uv"].to(torch.float32))
    y = einsum("bshe,hed->bsd", out.to(x.dtype), params["wo"])
    pos.add_(x.shape[1])
    return y, cache


def init_mla_cache(batch: int, ctx: int, cfg: AttnConfig, dtype=torch.bfloat16,
                   device=None) -> dict:
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, ctx, m.kv_lora), dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, ctx, m.rope_dim), dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}
