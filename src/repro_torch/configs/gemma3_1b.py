"""gemma3-1b [dense]: 26L d1152 4H (GQA kv=1) ff6912 vocab 262144.
5:1 sliding(512):global pattern, qk-norm, dual rope theta (10k local / 1M
global), tied embeddings, sqrt(d) embedding scale. [hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import (
    MASK_CAUSAL, MASK_SLIDING, AttnConfig, LayerSpec, ModelConfig,
)

FAMILY = "decoder"
LONG_CONTEXT_OK = True  # sliding-window dominant; sparse global layers are
                        # sequence-sharded at long context

_WINDOW = 512


def _pattern(n_layers: int, window: int) -> tuple:
    specs = []
    for i in range(n_layers):
        if (i + 1) % 6 == 0:  # every 6th layer: global full attention
            specs.append(LayerSpec(mask_mode=MASK_CAUSAL, rope_theta=1e6))
        else:
            specs.append(LayerSpec(mask_mode=MASK_SLIDING, window=window, rope_theta=1e4))
    return tuple(specs)


def get_config(reduced: bool = False) -> ModelConfig:
    if reduced:
        attn = AttnConfig(n_heads=4, n_kv_heads=1, head_dim=16, d_model=64, qk_norm=True)
        return ModelConfig(
            name="gemma3-1b-smoke", n_layers=6, d_model=64, d_ff=128, vocab=512,
            attn=attn, tie_embeddings=True, emb_scale=True, pattern=_pattern(6, 8),
        )
    attn = AttnConfig(n_heads=4, n_kv_heads=1, head_dim=256, d_model=1152, qk_norm=True)
    return ModelConfig(
        name="gemma3-1b", n_layers=26, d_model=1152, d_ff=6912, vocab=262144,
        attn=attn, tie_embeddings=True, emb_scale=True, pattern=_pattern(26, _WINDOW),
    )
