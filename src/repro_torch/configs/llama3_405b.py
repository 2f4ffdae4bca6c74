"""llama3-405b [dense]: 126L d16384 128H (GQA kv=8) ff53248 vocab 128256.
[arXiv:2407.21783]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, default_pattern

FAMILY = "decoder"
LONG_CONTEXT_OK = False


def get_config(reduced: bool = False) -> ModelConfig:
    if reduced:
        attn = AttnConfig(n_heads=8, n_kv_heads=2, head_dim=16, d_model=128, rope_theta=5e5)
        return ModelConfig(
            name="llama3-405b-smoke", n_layers=3, d_model=128, d_ff=256, vocab=512,
            attn=attn, pattern=default_pattern(3, rope_theta=5e5),
        )
    attn = AttnConfig(n_heads=128, n_kv_heads=8, head_dim=128, d_model=16384, rope_theta=5e5)
    return ModelConfig(
        name="llama3-405b", n_layers=126, d_model=16384, d_ff=53248, vocab=128256,
        attn=attn, pattern=default_pattern(126, rope_theta=5e5),
    )
