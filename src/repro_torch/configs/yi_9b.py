"""yi-9b [dense]: 48L d4096 32H (GQA kv=4) ff11008 vocab 64000 (llama arch).
[arXiv:2403.04652]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, default_pattern

FAMILY = "decoder"
LONG_CONTEXT_OK = False


def get_config(reduced: bool = False) -> ModelConfig:
    if reduced:
        attn = AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16, d_model=64, rope_theta=5e6)
        return ModelConfig(
            name="yi-9b-smoke", n_layers=2, d_model=64, d_ff=128, vocab=512,
            attn=attn, pattern=default_pattern(2, rope_theta=5e6),
        )
    attn = AttnConfig(n_heads=32, n_kv_heads=4, head_dim=128, d_model=4096, rope_theta=5e6)
    return ModelConfig(
        name="yi-9b", n_layers=48, d_model=4096, d_ff=11008, vocab=64000,
        attn=attn, pattern=default_pattern(48, rope_theta=5e6),
    )
