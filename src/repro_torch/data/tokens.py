"""Synthetic LM token pipeline, port of ``repro/data/tokens.py`` (``:18-43``).

Batches are addressed by step index (``batch_at``), so the restart loop
replays exactly after a restore.  Pure numpy, with the reference's seeds
and draws: both packages see the same batches, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    zipf_a: float = 1.2  # natural-language-ish marginal distribution


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        # Zipfian unigram table (clipped to vocab)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Deterministic int32 ``tokens`` / ``targets`` [batch, seq] for a
        global step (replayable)."""
        rng = np.random.default_rng((self.cfg.seed << 20) ^ step)
        toks = rng.choice(self.cfg.vocab, size=(self.cfg.batch, self.cfg.seq + 1), p=self._p)
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
