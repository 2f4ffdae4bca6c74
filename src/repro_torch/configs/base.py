"""Config helpers shared by the per-architecture files (port of
``repro/configs/base.py``)."""
from __future__ import annotations

from repro_torch.models.attention import (MASK_CAUSAL, MASK_CHUNKED, MASK_SLIDING, AttnConfig,
                                          MLAConfig)
from repro_torch.models.decoder import LayerSpec, ModelConfig, default_pattern
from repro_torch.models.mlp import MoEConfig
from repro_torch.models.ssm import Mamba2Config, RWKV6Config

__all__ = [
    "AttnConfig", "MLAConfig", "MoEConfig", "Mamba2Config", "RWKV6Config",
    "LayerSpec", "ModelConfig", "default_pattern",
    "MASK_CAUSAL", "MASK_SLIDING", "MASK_CHUNKED",
]
