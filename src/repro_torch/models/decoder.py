"""The decoder LM, port of ``repro/models/decoder.py`` (``:25-334``):
``LayerSpec``, ``ModelConfig``, stages, and ``DecoderLM``'s init, decode
caches, forward (with or without a cache), loss and decode step, for
every decoder family: dense GQA (granite, yi, llama3), sliding-window
with qk-norm and a scaled embedding (gemma3), chunked-local with NoPE
globals and MoE (llama4-scout), MLA with MoE (deepseek-v3), M-RoPE
(qwen2-vl), RWKV6 (rwkv6-7b), and Mamba2 with one shared attention block
(zamba2).

Parameters are the reference's tree: ``embed``, ``final_norm``,
``lm_head`` (untied models), ``shared`` (the shared block), and per stage
``stage{i}``, a list over the stage's period of per-layer dicts whose
leaves are stacked on a leading ``count`` axis (``None`` in a shared
block's slot: ``apply`` runs ``params["shared"]`` there).  So checkpoints
and AdamW trees match the reference's.  A forward takes each stacked
leaf's per-layer views with one ``torch.unbind`` (whose backward stacks
the layers' gradients into one tensor) and runs the layers in order;
without a cache and with ``cfg.remat`` each period runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
scan body).  Caches stack the same way, one tree a stage slot with a
leading ``count`` axis (each invocation of the shared block has its own
KV cache), and a decode writes them in place through the same per-layer
views: KV caches, RWKV6's token shifts and WKV state, Mamba2's conv and
SSM states.

RWKV6 layers keep the reference's feed-forward ``ffn`` (its spec has
``has_ffn``): the reference initialises it and never reads it (the
channel mix runs from ``mix``), so here too it is carried and read by no
forward; its gradient is zero (ROADMAP Queue 3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models import ssm as S
from repro_torch.models.common import layer_norm, normal_init, rms_norm, shard_constraint
from repro_torch.models.spmd import einsum, embed_lookup, replicate_dim


@dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"          # attn | mla | rwkv6 | mamba2 | shared_attn
    mask_mode: int = A.MASK_CAUSAL
    window: int = 0             # sliding/chunked extent
    rope_on: bool = True
    rope_theta: float = 1e4
    moe: bool = False           # MoE feed-forward instead of dense
    has_ffn: bool = True        # rwkv6/mamba2 blocks carry their own mixer


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: Optional[A.AttnConfig] = None
    moe: Optional[M.MoEConfig] = None
    rwkv: Optional[S.RWKV6Config] = None
    mamba: Optional[S.Mamba2Config] = None
    act: str = "silu"
    norm: str = "rms"
    pattern: tuple[LayerSpec, ...] = ()   # len == n_layers (built by configs/)
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    emb_scale: bool = False               # gemma-style sqrt(d) embedding scale
    dtype: str = "bf16"
    remat: bool = True
    # encoder-decoder extras (whisper)
    enc_layers: int = 0
    enc_seq: int = 0
    # zamba2: one shared transformer block reused at 'shared_attn' layers
    shared_block: bool = False
    shared_d_ff: int = 0

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bf16" else torch.float32


def default_pattern(n_layers: int, **kw) -> tuple[LayerSpec, ...]:
    return tuple(LayerSpec(**kw) for _ in range(n_layers))


@dataclass(frozen=True)
class Stage:
    specs: tuple[LayerSpec, ...]  # one period
    count: int                    # repeats


def build_stages(pattern: tuple[LayerSpec, ...], max_period: int = 8) -> tuple[Stage, ...]:
    """Greedy periodic run-length grouping of the layer pattern (the
    reference's, so both packages stack the same layers together)."""
    stages: list[Stage] = []
    i = 0
    n = len(pattern)
    while i < n:
        best = (1, 1)  # (period, count)
        for p in range(1, max_period + 1):
            if i + p > n:
                break
            period = pattern[i : i + p]
            count = 1
            while i + (count + 1) * p <= n and pattern[i + count * p : i + (count + 1) * p] == period:
                count += 1
            if p * count > best[0] * best[1] or (p * count == best[0] * best[1] and p < best[0]):
                best = (p, count)
        p, c = best
        stages.append(Stage(specs=pattern[i : i + p], count=c))
        i += p * c
    return tuple(stages)


def _init_layer(cfg: ModelConfig, spec: LayerSpec, generator: torch.Generator, dtype) -> dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=generator.device)
    p = {"ln1": zeros()}
    if spec.kind in ("attn", "shared_attn"):
        p["attn"] = A.init_gqa_params(cfg.attn, generator=generator, dtype=dtype)
    elif spec.kind == "mla":
        p["attn"] = A.init_mla_params(cfg.attn, generator=generator, dtype=dtype)
    elif spec.kind == "rwkv6":
        p["mix"] = S.init_rwkv6_params(cfg.rwkv, generator=generator, dtype=dtype)
    elif spec.kind == "mamba2":
        p["mix"] = S.init_mamba2_params(cfg.mamba, generator=generator, dtype=dtype)
    else:
        raise ValueError(spec.kind)
    if spec.has_ffn:
        p["ln2"] = zeros()
        if spec.moe:
            p["ffn"] = M.init_moe_params(cfg.d_model, cfg.moe, generator=generator, dtype=dtype)
        else:
            d_ff = cfg.shared_d_ff if spec.kind == "shared_attn" and cfg.shared_d_ff else cfg.d_ff
            p["ffn"] = M.init_mlp_params(cfg.d_model, d_ff, cfg.act, generator=generator,
                                         dtype=dtype)
    return p


def _norm(cfg: ModelConfig, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``cfg.norm``: "rms", or "layer" with scale ``1 + scale`` (rounded to
    the scale's dtype, as the reference's) and a zero bias."""
    if cfg.norm == "rms":
        return rms_norm(x, scale)
    return layer_norm(x, 1.0 + scale, torch.zeros_like(scale))


def _apply_layer(params: dict, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                 positions: torch.Tensor, cache: dict | None):
    """Returns (x, aux loss); the aux loss is None for a layer without an
    MoE feed-forward.  A cache is written in place."""
    h = _norm(cfg, x, params["ln1"])
    if spec.kind in ("attn", "shared_attn"):
        y, _ = A.gqa_attention(params["attn"], cfg.attn, h, positions,
                               mask_mode=spec.mask_mode, window=spec.window,
                               rope_on=spec.rope_on, rope_theta=spec.rope_theta, cache=cache)
    elif spec.kind == "mla":
        y, _ = A.mla_attention(params["attn"], cfg.attn, h, positions, cache=cache)
    elif spec.kind == "rwkv6":
        y, _ = S.rwkv6_time_mix(params["mix"], cfg.rwkv, h, None if cache is None else cache["tm"])
    elif spec.kind == "mamba2":
        y, _ = S.mamba2_mix(params["mix"], cfg.mamba, h, cache)
    else:
        raise ValueError(spec.kind)
    x = x + y
    aux = None
    if spec.has_ffn:
        h = _norm(cfg, x, params["ln2"])
        if spec.kind == "rwkv6":  # the channel mix; the layer's ``ffn`` is never read
            y, _ = S.rwkv6_channel_mix(params["mix"], cfg.rwkv, h,
                                       None if cache is None else cache["cm"])
        elif spec.moe:
            y, aux = M.apply_moe(params["ffn"], h, cfg.moe)
        else:
            y = M.apply_mlp(params["ffn"], h, cfg.act)
        x = x + y
    return x, aux


def _act_spec(batch_axes):
    """[B, S, d] activations sharded on the batch axes."""
    from repro_torch.launch.sharding import P

    return P(batch_axes, None, None)


def gold_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``logits[..., targets]`` (float32 logits [..., V], integer targets
    [...]).  A plain tensor gathers; a DTensor (vocab possibly sharded,
    where DTensor has no gather) sums the logits under a one-hot of the
    targets, which selects the same value exactly (every other term is a
    zero)."""
    from torch.distributed.tensor import DTensor

    idx = targets.to(torch.int64)[..., None]
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, idx)[..., 0]
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(idx == vocab, logits, 0.0).sum(-1)


def _init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, ctx: int, dtype,
                      device) -> dict:
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    if spec.kind in ("attn", "shared_attn"):
        return A.init_gqa_cache(batch, ctx, cfg.attn, window=spec.window, dtype=dtype,
                                device=device)
    if spec.kind == "mla":
        return A.init_mla_cache(batch, ctx, cfg.attn, dtype=dtype, device=device)
    if spec.kind == "rwkv6":
        r = cfg.rwkv
        return {"tm": {"shift": zeros(batch, cfg.d_model),
                       "wkv": zeros(batch, r.n_heads, r.head_dim, r.head_dim,
                                    dt=torch.float32)},
                "cm": zeros(batch, cfg.d_model)}
    if spec.kind == "mamba2":
        m = cfg.mamba
        return {"conv": zeros(batch, m.conv_width - 1, m.d_inner + 2 * m.d_state),
                "ssm": zeros(batch, m.n_heads, m.head_dim, m.d_state, dt=torch.float32)}
    raise ValueError(spec.kind)


def stack_layers(count: int, draw):
    """``count`` trees from ``draw()`` (a layer, or a period's list of
    layers with None in a shared slot) stacked leaf by leaf on a leading
    axis.  Each is written into the stacked leaves as it is drawn (one
    alone keeps its own tensors), so the transient is one draw, not a
    second copy of the weights."""
    stacked = None
    for c in range(count):
        layer = draw()
        if count == 1:
            return tree.rebuild(layer, lambda _, t: t.unsqueeze(0))
        if c == 0:
            stacked = tree.rebuild(layer, lambda _, t: t.new_empty((count, *t.shape)))
        for path, t in tree.leaves(layer):
            tree.get(stacked, path)[c].copy_(t)
    return stacked


def _unstack(stacked, count: int) -> list:
    """A stage slot's stacked tree -> ``count`` per-layer trees of views,
    one ``torch.unbind`` per leaf."""
    views = {path: torch.unbind(replicate_dim(leaf, 0), 0) for path, leaf in tree.leaves(stacked)}
    return [tree.rebuild(stacked, lambda path, _, c=c: views[path][c]) for c in range(count)]


class DecoderLM:
    """init/apply-style decoder LM (an explicit parameter tree) on
    ``device`` (None: the CUDA device, which must exist)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        if len(cfg.pattern) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: pattern has {len(cfg.pattern)} layers, "
                             f"n_layers is {cfg.n_layers}")
        self.cfg = cfg
        self.stages = build_stages(cfg.pattern)
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters in ``cfg.dtype``, drawn from ``generator``
        (which must live on the model's device).  Each period is written
        into its stage's stacked leaves as it is drawn (``stack_layers``),
        so the transient is one period and one float32 draw, not a second
        copy of the weights.  A shared block's slots hold None."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        cfg, dtype = self.cfg, self.cfg.compute_dtype
        params: dict = {
            "embed": normal_init((cfg.vocab, cfg.d_model), cfg.d_model ** -0.5,
                                 generator=generator, dtype=dtype),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = normal_init((cfg.d_model, cfg.vocab), cfg.d_model ** -0.5,
                                            generator=generator, dtype=dtype)
        if cfg.shared_block:
            params["shared"] = _init_layer(cfg, LayerSpec(kind="shared_attn"), generator, dtype)
        for si, stage in enumerate(self.stages):
            params[f"stage{si}"] = stack_layers(stage.count, lambda stage=stage: [
                None if spec.kind == "shared_attn" and cfg.shared_block
                else _init_layer(cfg, spec, generator, dtype) for spec in stage.specs])
        return params

    def init_cache(self, batch: int, ctx: int, dtype=torch.bfloat16) -> list:
        """Zeroed decode caches on the model's device: per stage, a list
        over its period of per-layer trees stacked on a leading ``count``
        axis (``pos`` an int32 a layer), as the reference's."""
        caches = []
        for stage in self.stages:
            caches.append([tree.rebuild(
                _init_layer_cache(self.cfg, spec, batch, ctx, dtype, self.device),
                lambda _, t, n=stage.count: t.expand(n, *t.shape).clone())
                for spec in stage.specs])
        return caches

    def _period(self, stage: Stage, layer_params: list, x: torch.Tensor,
                positions: torch.Tensor, layer_caches: list | None, batch_axes=None):
        """One period of a stage -> (x, aux loss).  The aux loss is the
        period's LAST layer's (None if that layer is dense): the
        reference's scan body adds only the ``a`` its layer loop ends
        with, so an earlier MoE layer of a period adds nothing to the
        loss (ROADMAP Queue 3); the port adds what the reference adds."""
        a = None
        for pi, (lp, spec) in enumerate(zip(layer_params, stage.specs)):
            x, a = _apply_layer(lp, self.cfg, spec, x, positions,
                                None if layer_caches is None else layer_caches[pi])
            if batch_axes is not None:
                x = shard_constraint(x, _act_spec(batch_axes))
        return x, a

    def apply(self, params: dict, tokens: torch.Tensor, positions: torch.Tensor,
              cache: list | None = None, batch_axes=None):
        """tokens [B, S] (integer), positions [S] ([B, 3, S] for M-RoPE)
        -> (logits [B, S, V] in the parameters' dtype, cache, aux loss).
        With a cache (from ``init_cache``) the new keys, values and
        recurrent states are written into it in place and it is returned;
        without one the cache returned is None.  ``batch_axes`` (mesh axis
        names) constrains the activations to batch-sharded after the
        embedding and after every layer, as the reference does; it acts on
        DTensors only (``shard_constraint``)."""
        cfg = self.cfg
        x = embed_lookup(tokens, params["embed"])
        if cfg.emb_scale:  # sqrt(d) rounded to the activations' dtype first, as the reference
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
        if batch_axes is not None:
            x = shard_constraint(x, _act_spec(batch_axes))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for si, stage in enumerate(self.stages):
            slots = [_unstack(lp, stage.count) for lp in params[f"stage{si}"]]
            cslots = (None if cache is None
                      else [_unstack(lc, stage.count) for lc in cache[si]])
            for c in range(stage.count):
                layer_params = [params["shared"] if slot[c] is None else slot[c]
                                for slot in slots]
                if cache is not None:
                    x, a = self._period(stage, layer_params, x, positions,
                                        [slot[c] for slot in cslots], batch_axes)
                elif cfg.remat:
                    x, a = checkpoint(self._period, stage, layer_params, x, positions, None,
                                      batch_axes, use_reentrant=False)
                else:
                    x, a = self._period(stage, layer_params, x, positions, None, batch_axes)
                if a is not None:
                    aux = aux + a
        x = _norm(cfg, x, params["final_norm"])
        if cfg.tie_embeddings:
            logits = einsum("bsd,vd->bsv", x, params["embed"])
        else:
            logits = einsum("bsd,dv->bsv", x, params["lm_head"])
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        return logits, cache, aux

    def loss(self, params: dict, tokens: torch.Tensor, targets: torch.Tensor,
             positions: torch.Tensor, batch_axes=None):
        """Mean next-token NLL plus the 1e-4 logz^2 z-loss and the MoE
        balance loss, in float32.  Returns (loss, {"nll", "aux"})."""
        logits, _, aux = self.apply(params, tokens, positions, batch_axes=batch_axes)
        logits = logits.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = gold_logits(logits, targets)
        nll = (logz - gold).mean()
        zloss = 1e-4 * (logz ** 2).mean()
        return nll + zloss + aux, {"nll": nll, "aux": aux}

    def decode_step(self, params: dict, cache: list, token: torch.Tensor, pos,
                    batch_axes=None):
        """token [B, 1]; pos the absolute position (an int, or an integer
        tensor on the model's device: a 0-d one costs no host sync) ->
        (logits [B, V], cache).  Under M-RoPE a 0-d ``pos`` is every
        stream's position, [B, 3, 1]."""
        pos = torch.as_tensor(pos, device=self.device)
        a = self.cfg.attn
        if a is not None and a.mrope_sections is not None and pos.ndim == 0:
            positions = pos.to(torch.int32).reshape(1, 1, 1).expand(token.shape[0], 3, 1)
        else:
            positions = pos[None] if pos.ndim == 0 else pos
        logits, cache, _ = self.apply(params, token, positions, cache=cache,
                                      batch_axes=batch_axes)
        return logits[:, -1], cache
