"""llama4-scout-17b-a16e [moe]: 48L d5120 40H (GQA kv=8), MoE 16e top-1 +
shared expert (ff 8192 each), iRoPE: every 4th layer NoPE-global, others
chunked-local(8192).  Early-fusion frontend is outside the assigned backbone.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs.base import (
    MASK_CAUSAL, MASK_CHUNKED, AttnConfig, LayerSpec, ModelConfig, MoEConfig,
)

FAMILY = "decoder"
LONG_CONTEXT_OK = True  # chunked-local dominant; sparse NoPE-global layers


def _pattern(n_layers: int, chunk: int) -> tuple:
    specs = []
    for i in range(n_layers):
        if i % 4 == 3:  # NoPE global
            specs.append(LayerSpec(mask_mode=MASK_CAUSAL, rope_on=False, moe=True))
        else:
            specs.append(LayerSpec(mask_mode=MASK_CHUNKED, window=chunk, rope_theta=5e5, moe=True))
    return tuple(specs)


def get_config(reduced: bool = False) -> ModelConfig:
    if reduced:
        attn = AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16, d_model=64)
        moe = MoEConfig(n_experts=4, top_k=1, d_ff=64, n_shared=1, shared_d_ff=64,
                        capacity_factor=4.0)
        return ModelConfig(
            name="llama4-scout-smoke", n_layers=4, d_model=64, d_ff=64, vocab=512,
            attn=attn, moe=moe, pattern=_pattern(4, 8),
        )
    attn = AttnConfig(n_heads=40, n_kv_heads=8, head_dim=128, d_model=5120)
    moe = MoEConfig(n_experts=16, top_k=1, d_ff=8192, n_shared=1, shared_d_ff=8192)
    return ModelConfig(
        name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, d_ff=8192, vocab=202048,
        attn=attn, moe=moe, pattern=_pattern(48, 8192),
    )
