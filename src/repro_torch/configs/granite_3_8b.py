"""granite-3-8b [dense]: 40L d4096 32H (GQA kv=8) ff12800 vocab 49155.
[hf:ibm-granite/granite-3.0; GQA, tied embeddings]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, default_pattern

FAMILY = "decoder"
LONG_CONTEXT_OK = False  # pure full attention -> skip long_500k


def get_config(reduced: bool = False) -> ModelConfig:
    if reduced:
        attn = AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16, d_model=64, rope_theta=1e4)
        return ModelConfig(
            name="granite-3-8b-smoke", n_layers=2, d_model=64, d_ff=128, vocab=512,
            attn=attn, tie_embeddings=True,
            pattern=default_pattern(2, rope_theta=1e4),
        )
    attn = AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128, d_model=4096, rope_theta=1e4)
    return ModelConfig(
        name="granite-3-8b", n_layers=40, d_model=4096, d_ff=12800, vocab=49155,
        attn=attn, tie_embeddings=True,
        pattern=default_pattern(40, rope_theta=1e4),
    )
