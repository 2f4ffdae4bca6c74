"""Streaming plans: tile-batch sizing against a byte budget (port of
``repro/exec/plan.py``).

A plan turns (volume shape, tile grid, memory budget) into a sequence of
contiguous row-major tile-id runs.  Two invariants matter:

* every batch has the SAME tile count (the final short run is padded at
  execution time), so every batch the device encodes has one shape,
* with the executor's one-batch-in-flight overlap, at most two batches of
  working set are alive at once, so each batch is sized to half the
  budget, keeping the tracked peak within it (asserted at <= 2x for
  safety against allocator slack).

The reference's ``bucketed_batch_tiles`` has no counterpart: it prices the
bucket-padded decode batches of ``dispatch_bucketed``, and the port's
decode pads no batch (eager PyTorch compiles nothing per batch size), so
the serving daemon prices lanes x :func:`tile_working_bytes`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.sz.predictor import _padded_shape
from repro_torch.sz.tiled import tile_grid


def tile_working_bytes(tile: tuple[int, ...], predictor: str, levels: int,
                       *, device_entropy: bool = False) -> int:
    """Conservative per-tile working-set estimate for one streamed tile:
    f32 input + the predictor's payload leaves + its recon.

    ``device_entropy`` adds the device encode-pack words (one u32 lane per
    symbol, held until the host stage splices the lane blob)."""
    t = int(np.prod(tile))
    extra = 4 * t if device_entropy else 0
    if predictor == "interp":
        p = int(np.prod(_padded_shape(tile, levels)))
        # codes i32 + omask bool + ovals f32 + recon f32 on the padded grid
        return 4 * t + 13 * p + extra
    # lorenzo: codes i32 + recon f32 on the tile grid
    return 4 * t + 8 * t + extra


def max_inflight_tiles(mem_budget: int, tile: tuple[int, ...], *,
                       predictor: str = "lorenzo", levels: int = 0) -> int:
    """Admission width for concurrent DECODE: how many tiles may be in
    flight at once before their working sets overflow ``mem_budget``.

    The per-tile cost reuses :func:`tile_working_bytes` (decode walks the
    same payload leaves the streamed encode does), so decode admission and
    the streaming executor's batch sizing are two views of one byte budget.
    Always admits at least one tile: a budget smaller than a single working
    set serializes requests rather than deadlocking them."""
    per = tile_working_bytes(tile, predictor, levels)
    return max(1, int(mem_budget) // per)


@dataclass(frozen=True)
class StreamPlan:
    shape: tuple[int, ...]
    tile: tuple[int, ...]
    grid: tuple[int, ...]
    n_tiles: int
    batch_tiles: int  # uniform device-batch width
    mem_budget: int
    tile_bytes: int  # per-tile working-set estimate
    device_entropy: bool = False  # lane packing runs in the device stage

    @property
    def n_batches(self) -> int:
        return -(-self.n_tiles // self.batch_tiles)

    def batches(self, start_tile: int = 0):
        """Contiguous row-major id runs: range(a, b) per batch.

        ``start_tile`` (a batch-aligned tile id, see :meth:`resume_point`)
        skips the already-committed prefix when resuming an interrupted
        stream: the remaining runs are exactly the ones an uninterrupted
        stream would have produced."""
        if start_tile % self.batch_tiles:
            raise ValueError(
                f"start_tile {start_tile} is not aligned to the batch width "
                f"{self.batch_tiles}")
        for a in range(start_tile, self.n_tiles, self.batch_tiles):
            yield range(a, min(a + self.batch_tiles, self.n_tiles))

    def resume_point(self, committed_lanes: int) -> int:
        """Round a writer's commit point *down* to a batch boundary.

        Resume re-encodes whole batches (the encode is deterministic per
        batch), so a commit landing mid-batch surrenders the partial batch
        and restarts it: the price of byte-identical output."""
        committed_lanes = min(int(committed_lanes), self.n_tiles)
        return (committed_lanes // self.batch_tiles) * self.batch_tiles


def plan_stream(shape: tuple[int, ...], tile: tuple[int, ...], mem_budget: int, *,
                predictor: str = "lorenzo", levels: int = 0,
                device_entropy: bool = False) -> StreamPlan:
    """Size tile batches so ~two in-flight batches fit the byte budget.

    The port runs on one device, so the batch width is never rounded to a
    device-count multiple (the reference's ``devices=1``)."""
    grid = tile_grid(shape, tile)
    n_tiles = int(np.prod(grid))
    per = tile_working_bytes(tile, predictor, levels, device_entropy=device_entropy)
    batch = max(1, int(mem_budget) // (2 * per))
    batch = min(batch, n_tiles)
    return StreamPlan(shape=tuple(shape), tile=tuple(tile), grid=grid,
                      n_tiles=n_tiles, batch_tiles=batch,
                      mem_budget=int(mem_budget), tile_bytes=per,
                      device_entropy=device_entropy)
