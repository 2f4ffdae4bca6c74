"""qwen2-vl-7b [vlm]: 28L d3584 28H (GQA kv=4) ff18944 vocab 152064, M-RoPE
sections (16,24,24).  The vision frontend is a stub, as in the reference: the batch
carries the 3-stream positions; patch embeddings enter as ordinary tokens.
[arXiv:2409.12191]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, default_pattern

FAMILY = "decoder"
LONG_CONTEXT_OK = False
MROPE = (16, 24, 24)


def get_config(reduced: bool = False) -> ModelConfig:
    if reduced:
        attn = AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16, d_model=64,
                          mrope_sections=(2, 3, 3), mrope_theta=1e6)
        return ModelConfig(
            name="qwen2-vl-smoke", n_layers=2, d_model=64, d_ff=128, vocab=512,
            attn=attn, pattern=default_pattern(2),
        )
    attn = AttnConfig(n_heads=28, n_kv_heads=4, head_dim=128, d_model=3584,
                      mrope_sections=MROPE, mrope_theta=1e6)
    return ModelConfig(
        name="qwen2-vl-7b", n_layers=28, d_model=3584, d_ff=18944, vocab=152064,
        attn=attn, pattern=default_pattern(28),
    )
