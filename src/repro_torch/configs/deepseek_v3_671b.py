"""deepseek-v3-671b [moe]: 61L d7168 128H MLA, 1 shared + 256 routed top-8,
expert ff 2048, first 3 layers dense (ff 18432), sigmoid router, vocab 129280.
MTP head available behind a config flag (off in dry-run shapes).
[arXiv:2412.19437]"""
from repro_torch.configs.base import AttnConfig, LayerSpec, MLAConfig, ModelConfig, MoEConfig

FAMILY = "decoder"
LONG_CONTEXT_OK = False  # MLA is still dense softmax over all positions


def _pattern(n_layers: int, first_dense: int) -> tuple:
    return tuple(
        LayerSpec(kind="mla", moe=(i >= first_dense)) for i in range(n_layers)
    )


def get_config(reduced: bool = False) -> ModelConfig:
    if reduced:
        mla = MLAConfig(q_lora=32, kv_lora=16, rope_dim=8, nope_dim=16, v_dim=16)
        attn = AttnConfig(n_heads=4, n_kv_heads=4, head_dim=24, d_model=64, mla=mla)
        moe = MoEConfig(n_experts=4, top_k=2, d_ff=32, n_shared=1, shared_d_ff=32,
                        router="sigmoid", first_dense=1, capacity_factor=4.0)
        return ModelConfig(
            name="deepseek-v3-smoke", n_layers=3, d_model=64, d_ff=128, vocab=512,
            attn=attn, moe=moe, pattern=_pattern(3, 1),
        )
    mla = MLAConfig(q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128, v_dim=128)
    attn = AttnConfig(n_heads=128, n_kv_heads=128, head_dim=192, d_model=7168, mla=mla)
    moe = MoEConfig(n_experts=256, top_k=8, d_ff=2048, n_shared=1, shared_d_ff=2048,
                    router="sigmoid", first_dense=3)
    return ModelConfig(
        name="deepseek-v3-671b", n_layers=61, d_model=7168, d_ff=18432, vocab=129280,
        attn=attn, moe=moe, pattern=_pattern(61, 3),
    )
