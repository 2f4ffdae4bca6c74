"""rwkv6-7b [ssm]: 32L d4096 (attention-free) channel-mix ff 14336,
vocab 65536, head 64, data-dependent decay (Finch). [arXiv:2404.05892]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, RWKV6Config

FAMILY = "decoder"
LONG_CONTEXT_OK = True  # O(1) recurrent state


def get_config(reduced: bool = False) -> ModelConfig:
    if reduced:
        rwkv = RWKV6Config(d_model=64, head_dim=16, d_ff=128, lora_mix=8, lora_decay=8)
        return ModelConfig(
            name="rwkv6-smoke", n_layers=2, d_model=64, d_ff=128, vocab=512,
            rwkv=rwkv, pattern=tuple(LayerSpec(kind="rwkv6") for _ in range(2)),
        )
    rwkv = RWKV6Config(d_model=4096, head_dim=64, d_ff=14336)
    return ModelConfig(
        name="rwkv6-7b", n_layers=32, d_model=4096, d_ff=14336, vocab=65536,
        rwkv=rwkv, pattern=tuple(LayerSpec(kind="rwkv6") for _ in range(32)),
    )
