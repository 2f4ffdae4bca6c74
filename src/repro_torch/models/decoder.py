"""The decoder LM for the dense GQA family (granite, yi, llama3), port of
``repro/models/decoder.py`` (``:25-323``): ``LayerSpec``, ``ModelConfig``,
stages, and ``DecoderLM``'s init, forward without a cache, and loss.

Parameters are the reference's tree: ``embed``, ``final_norm``,
``lm_head`` (untied models), and per stage ``stage{i}``, a list over the
stage's period of per-layer dicts whose leaves are stacked on a leading
``count`` axis.  So checkpoints and AdamW trees match the reference's.  A
forward takes each stacked leaf's per-layer views with one
``torch.unbind`` (whose backward stacks the layers' gradients into one
tensor) and runs the layers in order; with ``cfg.remat`` each period runs
under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of
its scan body).

Mechanisms the dense family does not use are not ported yet, and a model
that asks for one is refused when it is built (``NotImplementedError``):
MLA, MoE, RWKV6, Mamba2, shared blocks, sliding and chunked masks,
M-RoPE, qk-norm, softcaps, ``emb_scale``, layer norm, GELU and the
encoder-decoder.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models.common import normal_init, rms_norm


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
    moe: Optional[object] = None
    rwkv: Optional[object] = None
    mamba: Optional[object] = None
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


def _unported(cfg: ModelConfig) -> list[str]:
    """The mechanisms ``cfg`` asks for that the port does not have yet."""
    a = cfg.attn
    bad = [name for name, on in (
        ("an attention config", a is None),
        ("MoE", cfg.moe is not None), ("RWKV6", cfg.rwkv is not None),
        ("Mamba2", cfg.mamba is not None), ("shared blocks", cfg.shared_block),
        ("an encoder", cfg.enc_layers > 0), (f"act {cfg.act!r}", cfg.act != "silu"),
        (f"norm {cfg.norm!r}", cfg.norm != "rms"), ("logit softcap", bool(cfg.logit_softcap)),
        ("emb_scale", cfg.emb_scale)) if on]
    if a is not None:
        bad += [name for name, on in (
            ("MLA", a.mla is not None), ("qk-norm", a.qk_norm),
            ("M-RoPE", a.mrope_sections is not None), ("attention softcap", bool(a.softcap)))
            if on]
    for spec in cfg.pattern:
        bad += [name for name, on in (
            (f"layer kind {spec.kind!r}", spec.kind != "attn"),
            (f"mask mode {spec.mask_mode}", spec.mask_mode != A.MASK_CAUSAL),
            ("windowed attention", bool(spec.window)), ("MoE layers", spec.moe),
            ("layers without a feed-forward", not spec.has_ffn)) if on]
    return sorted(set(bad))


def _init_layer(cfg: ModelConfig, generator: torch.Generator, dtype) -> dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=generator.device)
    return {"ln1": zeros(), "attn": A.init_gqa_params(cfg.attn, generator=generator, dtype=dtype),
            "ln2": zeros(),
            "ffn": M.init_mlp_params(cfg.d_model, cfg.d_ff, generator=generator, dtype=dtype)}


def _apply_layer(params: dict, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, params["ln1"])
    x = x + A.gqa_attention(params["attn"], cfg.attn, h, positions, mask_mode=spec.mask_mode,
                            rope_on=spec.rope_on, rope_theta=spec.rope_theta)
    h = rms_norm(x, params["ln2"])
    return x + M.apply_mlp(params["ffn"], h)


def _unstack(stacked, count: int) -> list:
    """A stage slot's stacked tree -> ``count`` per-layer trees of views,
    one ``torch.unbind`` per leaf."""
    views = {path: torch.unbind(leaf, 0) for path, leaf in tree.leaves(stacked)}
    return [tree.rebuild(stacked, lambda path, _, c=c: views[path][c]) for c in range(count)]


class DecoderLM:
    """init/apply-style decoder LM (an explicit parameter tree) on
    ``device`` (None: the CUDA device, which must exist)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        if len(cfg.pattern) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: pattern has {len(cfg.pattern)} layers, "
                             f"n_layers is {cfg.n_layers}")
        bad = _unported(cfg)
        if bad:
            raise NotImplementedError(f"{cfg.name}: not ported yet: {', '.join(bad)}")
        self.cfg = cfg
        self.stages = build_stages(cfg.pattern)
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters in ``cfg.dtype``, drawn from ``generator``
        (which must live on the model's device)."""
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
        for si, stage in enumerate(self.stages):
            per = [[_init_layer(cfg, generator, dtype) for _ in stage.specs]
                   for _ in range(stage.count)]
            params[f"stage{si}"] = [
                tree.rebuild(per[0][pi], lambda path, _, pi=pi: torch.stack(
                    [tree.get(per[c][pi], path) for c in range(stage.count)]))
                for pi in range(len(stage.specs))]
        return params

    def _period(self, stage: Stage, layer_params: list, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        for lp, spec in zip(layer_params, stage.specs):
            x = _apply_layer(lp, self.cfg, spec, x, positions)
        return x

    def apply(self, params: dict, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] (integer), positions [S] -> logits [B, S, V] in the
        parameters' dtype."""
        cfg = self.cfg
        x = F.embedding(tokens.to(torch.int64), params["embed"])
        for si, stage in enumerate(self.stages):
            slots = [_unstack(lp, stage.count) for lp in params[f"stage{si}"]]
            for c in range(stage.count):
                layer_params = [slot[c] for slot in slots]
                if cfg.remat:
                    x = checkpoint(self._period, stage, layer_params, x, positions,
                                   use_reentrant=False)
                else:
                    x = self._period(stage, layer_params, x, positions)
        x = rms_norm(x, params["final_norm"])
        if cfg.tie_embeddings:
            return torch.einsum("bsd,vd->bsv", x, params["embed"])
        return torch.einsum("bsd,dv->bsv", x, params["lm_head"])

    def loss(self, params: dict, tokens: torch.Tensor, targets: torch.Tensor,
             positions: torch.Tensor):
        """Mean next-token NLL plus the 1e-4 logz^2 z-loss, in float32.
        Returns (loss, {"nll", "aux"}); aux (MoE balance) is 0 here."""
        logits = self.apply(params, tokens, positions).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.to(torch.int64)[..., None])[..., 0]
        nll = (logz - gold).mean()
        zloss = 1e-4 * (logz ** 2).mean()
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        return nll + zloss + aux, {"nll": nll, "aux": aux}
