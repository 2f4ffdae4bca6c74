"""Synthetic LM token pipeline and the science-volume block loader, port
of ``repro/data/tokens.py``.

Batches are addressed by step index (``batch_at``), so the restart loop
replays exactly after a restore; ``prefetch`` keeps the host ahead of the
device on a background thread.  Pure numpy, with the reference's seeds
and draws: both packages see the same batches, bit for bit.
"""
from __future__ import annotations

import queue
import threading
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

    def prefetch(self, start_step: int, depth: int = 2):
        """Generator of ``(step, batch_at(step))`` from ``start_step`` on,
        filled ahead by a background thread into a queue of ``depth``.
        Closing the generator stops the thread."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            s = start_step
            while not stop.is_set():
                item = (s, self.batch_at(s))
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                s += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            t.join(timeout=10)


class NyxBlockPipeline:
    """Sharded loader for science volumes: yields (block_coords, block)
    tiles of a large field, so multi-host GWLZ jobs stream the volume
    data-parallel."""

    def __init__(self, volume: np.ndarray, block: tuple[int, int, int]):
        self.volume = volume
        self.block = block
        Z, Y, X = volume.shape
        bz, by, bx = block
        if Z % bz or Y % by or X % bx:
            raise ValueError(f"block {block} does not tile the volume {volume.shape}")
        self.grid = (Z // bz, Y // by, X // bx)

    def __iter__(self):
        bz, by, bx = self.block
        for iz in range(self.grid[0]):
            for iy in range(self.grid[1]):
                for ix in range(self.grid[2]):
                    yield (iz, iy, ix), self.volume[iz * bz:(iz + 1) * bz,
                                                    iy * by:(iy + 1) * by,
                                                    ix * bx:(ix + 1) * bx]

    def shard(self, host_id: int, n_hosts: int):
        """Round-robin block assignment per host (data-parallel compression)."""
        for i, (coords, blk) in enumerate(self):
            if i % n_hosts == host_id:
                yield coords, blk
