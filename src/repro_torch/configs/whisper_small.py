"""whisper-small [audio]: 12L enc + 12L dec, d768 12H ff3072 vocab 51865.
The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings [B, 1500, 768]. [arXiv:2212.04356]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, default_pattern

FAMILY = "encdec"
LONG_CONTEXT_OK = False
ENC_SEQ = 1500


def get_config(reduced: bool = False) -> ModelConfig:
    if reduced:
        attn = AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16, d_model=64)
        return ModelConfig(
            name="whisper-small-smoke", n_layers=2, d_model=64, d_ff=128, vocab=512,
            attn=attn, act="gelu", norm="layer", enc_layers=2, enc_seq=32,
            pattern=default_pattern(2),
        )
    attn = AttnConfig(n_heads=12, n_kv_heads=12, head_dim=64, d_model=768)
    return ModelConfig(
        name="whisper-small", n_layers=12, d_model=768, d_ff=3072, vocab=51865,
        attn=attn, act="gelu", norm="layer", enc_layers=12, enc_seq=ENC_SEQ,
        pattern=default_pattern(12),
    )
