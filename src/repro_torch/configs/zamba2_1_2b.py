"""zamba2-1.2b [hybrid]: 38 Mamba2 layers (d2048, ssm_state=64) + ONE shared
transformer block (32H kv32 + ff8192) invoked every 6th layer with shared
weights (the per-invocation LoRA is omitted, as in the reference). [arXiv:2411.15242]"""
from repro_torch.configs.base import AttnConfig, LayerSpec, Mamba2Config, ModelConfig

FAMILY = "decoder"
LONG_CONTEXT_OK = True  # Mamba2 state + sequence-sharded shared-attn KV


def _pattern(n_layers: int, every: int) -> tuple:
    specs = []
    for i in range(n_layers):
        if (i + 1) % every == 0:
            specs.append(LayerSpec(kind="shared_attn"))
        else:
            specs.append(LayerSpec(kind="mamba2", has_ffn=False))
    return tuple(specs)


def get_config(reduced: bool = False) -> ModelConfig:
    if reduced:
        mamba = Mamba2Config(d_model=64, d_state=16, head_dim=16)
        attn = AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16, d_model=64)
        return ModelConfig(
            name="zamba2-smoke", n_layers=4, d_model=64, d_ff=128, vocab=512,
            mamba=mamba, attn=attn, shared_block=True, shared_d_ff=128,
            pattern=_pattern(4, 2),
        )
    mamba = Mamba2Config(d_model=2048, d_state=64, head_dim=64)
    attn = AttnConfig(n_heads=32, n_kv_heads=32, head_dim=64, d_model=2048)
    return ModelConfig(
        name="zamba2-1.2b", n_layers=38, d_model=2048, d_ff=8192, vocab=32000,
        mamba=mamba, attn=attn, shared_block=True, shared_d_ff=8192,
        pattern=_pattern(38, 6),
    )
