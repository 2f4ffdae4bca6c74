"""Architecture registry, port of ``repro/configs/__init__.py``:
``--arch <id>`` resolves here.  All ten of the reference's architectures,
in its order: nine decoders (``models/decoder.py``) and one
encoder-decoder (``models/encdec.py``)."""
from __future__ import annotations

import importlib

ARCH_IDS = ("granite-3-8b", "yi-9b", "gemma3-1b", "llama3-405b", "deepseek-v3-671b",
            "llama4-scout-17b-a16e", "rwkv6-7b", "whisper-small", "zamba2-1.2b", "qwen2-vl-7b")

_MODULES = {"granite-3-8b": "granite_3_8b", "yi-9b": "yi_9b", "gemma3-1b": "gemma3_1b",
            "llama3-405b": "llama3_405b", "deepseek-v3-671b": "deepseek_v3_671b",
            "llama4-scout-17b-a16e": "llama4_scout_17b_a16e", "rwkv6-7b": "rwkv6_7b",
            "whisper-small": "whisper_small", "zamba2-1.2b": "zamba2_1_2b",
            "qwen2-vl-7b": "qwen2_vl_7b"}


def arch_module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str, reduced: bool = False):
    return arch_module(arch_id).get_config(reduced=reduced)


def get_family(arch_id: str) -> str:
    return arch_module(arch_id).FAMILY


def long_context_ok(arch_id: str) -> bool:
    """Whether the arch runs the 500k-token context cell (sub-quadratic
    attention or a recurrent state)."""
    return arch_module(arch_id).LONG_CONTEXT_OK


def build_model(arch_id: str, reduced: bool = False, *, device=None):
    """Returns (model, cfg) for the arch, on ``device`` (None: the CUDA
    device, which must exist): a ``DecoderLM`` or an ``EncDecLM`` by the
    arch's family."""
    cfg = get_config(arch_id, reduced=reduced)
    fam = get_family(arch_id)
    if fam == "decoder":
        from repro_torch.models.decoder import DecoderLM

        return DecoderLM(cfg, device=device), cfg
    if fam == "encdec":
        from repro_torch.models.encdec import EncDecLM

        return EncDecLM(cfg, device=device), cfg
    raise ValueError(fam)
