"""Config helpers shared by the per-architecture files (port of
``repro/configs/base.py``: the dense decoders' part)."""
from __future__ import annotations

from repro_torch.models.attention import MASK_CAUSAL, AttnConfig
from repro_torch.models.decoder import LayerSpec, ModelConfig, default_pattern

__all__ = ["AttnConfig", "LayerSpec", "ModelConfig", "default_pattern", "MASK_CAUSAL"]
