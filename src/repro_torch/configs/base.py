"""Config helpers shared by the per-architecture files (port of
``repro/configs/base.py``: the attention families' part)."""
from __future__ import annotations

from repro_torch.models.attention import (MASK_CAUSAL, MASK_CHUNKED, MASK_SLIDING, AttnConfig,
                                          MLAConfig)
from repro_torch.models.decoder import LayerSpec, ModelConfig, default_pattern
from repro_torch.models.mlp import MoEConfig

__all__ = [
    "AttnConfig", "MLAConfig", "MoEConfig", "LayerSpec", "ModelConfig", "default_pattern",
    "MASK_CAUSAL", "MASK_SLIDING", "MASK_CHUNKED",
]
