"""Checkpoints of training state, GWLZ-compressed where large (port of
``repro/checkpoint``)."""
from repro_torch.checkpoint.gwlz_ckpt import compress_tensor, decompress_tensor
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager", "compress_tensor", "decompress_tensor"]
