"""The encoder-decoder LM (whisper's backbone), port of
``repro/models/encdec.py`` (``:20-129``).

The audio frontend (mel and convolutional downsampling) is a stub in the
reference, and so here: the encoder takes frame embeddings [B, T_enc, d].
The backbone is whole: a bidirectional encoder with sinusoidal positions,
a causal decoder with cross-attention and learned positions, pre-norm
layers (``cfg.norm``, layer norm for whisper) and logits tied to the
embedding.

Parameters are the reference's tree: ``embed``, ``pos_dec``, ``enc``
(encoder layers stacked on a leading axis), ``enc_norm``, ``dec``
(decoder layers stacked) and ``final_norm``.  The decode cache holds the
decoder's self-attention keys and values, ``{"self": ...}`` stacked over
the layers, written in place.  Cross-attention's keys and values are
recomputed from the encoder's output at every step, as the reference
does (its ``init_cache`` holds only ``self``; ROADMAP Queue 3).

``pos_dec`` has ``enc_seq + 8192`` rows.  The reference's gather clamps a
position past its last row (reusing that row); the port refuses a context
or a sequence that long (``ValueError``) and never indexes past it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models.common import normal_init, shard_constraint, sinusoidal_positions
from repro_torch.models.spmd import einsum, embed_lookup
from repro_torch.models.decoder import (ModelConfig, _act_spec, _norm, _unstack, gold_logits,
                                        stack_layers)


class EncDecLM:
    """init/apply-style encoder-decoder LM on ``device`` (None: the CUDA
    device, which must exist)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    @property
    def max_positions(self) -> int:
        """Rows of ``pos_dec``: the decoder's positions run below this."""
        return self.cfg.enc_seq + 8192

    def check_positions(self, n: int) -> None:
        """Raises ``ValueError`` where n decoder positions pass ``pos_dec``."""
        if n > self.max_positions:
            raise ValueError(f"{self.cfg.name}: {n} decoder positions, but pos_dec has "
                             f"{self.max_positions} rows")

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters in ``cfg.dtype`` drawn from ``generator`` (on
        the model's device); layers stacked as drawn (``stack_layers``)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        cfg, dtype = self.cfg, self.cfg.compute_dtype
        zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=self.device)
        attn = lambda: A.init_gqa_params(cfg.attn, generator=generator, dtype=dtype)
        ffn = lambda: M.init_mlp_params(cfg.d_model, cfg.d_ff, cfg.act, generator=generator,
                                        dtype=dtype)
        params = {
            "embed": normal_init((cfg.vocab, cfg.d_model), cfg.d_model ** -0.5,
                                 generator=generator, dtype=dtype),
            "pos_dec": normal_init((self.max_positions, cfg.d_model), 0.01,
                                   generator=generator, dtype=dtype),
        }
        params["enc"] = stack_layers(cfg.enc_layers, lambda: {
            "ln1": zeros(), "attn": attn(), "ln2": zeros(), "ffn": ffn()})
        params["enc_norm"] = zeros()
        params["dec"] = stack_layers(cfg.n_layers, lambda: {
            "ln1": zeros(), "attn": attn(), "ln_x": zeros(), "xattn": attn(), "ln2": zeros(),
            "ffn": ffn()})
        params["final_norm"] = zeros()
        return params

    # -- encoder -------------------------------------------------------------
    def _enc_layer(self, lp: dict, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = _norm(cfg, x, lp["ln1"])
        y, _ = A.gqa_attention(lp["attn"], cfg.attn, h, pos, mask_mode=A.MASK_BIDIR,
                               rope_on=False)
        x = x + y
        return x + M.apply_mlp(lp["ffn"], _norm(cfg, x, lp["ln2"]), cfg.act)

    def encode(self, params: dict, enc_feats: torch.Tensor, batch_axes=None) -> torch.Tensor:
        """enc_feats: [B, T, d] frame embeddings (the stub frontend's) ->
        the encoder's output [B, T, d].  ``batch_axes``: as
        ``DecoderLM.apply``'s (each layer's output batch-sharded)."""
        cfg = self.cfg
        T = enc_feats.shape[1]
        x = enc_feats + sinusoidal_positions(T, cfg.d_model, enc_feats.device).to(
            enc_feats.dtype)
        pos = torch.arange(T, device=x.device)
        for lp in _unstack(params["enc"], cfg.enc_layers):
            if cfg.remat:
                x = checkpoint(self._enc_layer, lp, x, pos, use_reentrant=False)
            else:
                x = self._enc_layer(lp, x, pos)
            if batch_axes is not None:
                x = shard_constraint(x, _act_spec(batch_axes))
        return _norm(cfg, x, params["enc_norm"])

    # -- decoder -------------------------------------------------------------
    def _dec_layer(self, lp: dict, x: torch.Tensor, enc_out: torch.Tensor,
                   positions: torch.Tensor, lc: dict | None) -> torch.Tensor:
        cfg = self.cfg
        h = _norm(cfg, x, lp["ln1"])
        y, _ = A.gqa_attention(lp["attn"], cfg.attn, h, positions, mask_mode=A.MASK_CAUSAL,
                               rope_on=False, cache=None if lc is None else lc["self"])
        x = x + y
        h = _norm(cfg, x, lp["ln_x"])
        y, _ = A.gqa_attention(lp["xattn"], cfg.attn, h, positions, mask_mode=A.MASK_BIDIR,
                               rope_on=False, kv_source=enc_out)
        x = x + y
        return x + M.apply_mlp(lp["ffn"], _norm(cfg, x, lp["ln2"]), cfg.act)

    def decode(self, params: dict, enc_out: torch.Tensor, tokens: torch.Tensor,
               positions: torch.Tensor, cache: dict | None = None, batch_axes=None):
        """tokens [B, S] at positions [S] against enc_out [B, T, d] ->
        (logits [B, S, V], cache).  A cache (``init_cache``) is written in
        place and returned; without one the cache returned is None."""
        cfg = self.cfg
        x = (embed_lookup(tokens, params["embed"])
             + params["pos_dec"][positions.to(torch.int64)])
        layers = _unstack(params["dec"], cfg.n_layers)
        caches = (None if cache is None
                  else [{"self": c} for c in _unstack(cache["self"], cfg.n_layers)])
        for i, lp in enumerate(layers):
            if cache is not None:
                x = self._dec_layer(lp, x, enc_out, positions, caches[i])
            elif cfg.remat:
                x = checkpoint(self._dec_layer, lp, x, enc_out, positions, None,
                               use_reentrant=False)
            else:
                x = self._dec_layer(lp, x, enc_out, positions, None)
            if batch_axes is not None:
                x = shard_constraint(x, _act_spec(batch_axes))
        x = _norm(cfg, x, params["final_norm"])
        return einsum("bsd,vd->bsv", x, params["embed"]), cache

    # -- steps ---------------------------------------------------------------
    def loss(self, params: dict, enc_feats: torch.Tensor, tokens: torch.Tensor,
             targets: torch.Tensor, batch_axes=None):
        """Mean next-token NLL plus the 1e-4 logz^2 z-loss, in float32.
        Returns (loss, {"nll"})."""
        self.check_positions(tokens.shape[1])
        enc_out = self.encode(params, enc_feats, batch_axes)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        logits, _ = self.decode(params, enc_out, tokens, positions, batch_axes=batch_axes)
        logits = logits.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = gold_logits(logits, targets)
        nll = (logz - gold).mean()
        return nll + 1e-4 * (logz ** 2).mean(), {"nll": nll}

    def init_cache(self, batch: int, ctx: int, dtype=torch.bfloat16) -> dict:
        """Zeroed self-attention caches, {"self": {"k", "v", "pos"}}, each
        stacked on a leading [n_layers] axis, as the reference's."""
        self.check_positions(ctx)
        one = A.init_gqa_cache(batch, ctx, self.cfg.attn, dtype=dtype, device=self.device)
        return {"self": tree.rebuild(
            one, lambda _, t: t.expand(self.cfg.n_layers, *t.shape).clone())}

    def decode_step(self, params: dict, cache: dict, enc_out: torch.Tensor,
                    token: torch.Tensor, pos, batch_axes=None):
        """token [B, 1]; pos the absolute position (an int, or an integer
        tensor on the model's device) -> (logits [B, V], cache)."""
        pos = torch.as_tensor(pos, device=self.device)
        logits, cache = self.decode(params, enc_out, token, pos[None] if pos.ndim == 0 else pos,
                                    cache=cache, batch_axes=batch_axes)
        return logits[:, -1], cache
