"""Bounded-memory streaming compression executor (port of
``repro/exec/executor.py``).

The volume never materializes: the plan's contiguous tile-id runs are
pulled from a :class:`~repro_torch.exec.sources.TileSource` one batch at a
time, on the host, and each batch goes through two stages:

* the **device stage**, on the caller's thread: the batch is uploaded,
  ``pred.encode_tiles`` runs the prequant + prediction kernels, and on a
  CUDA device ``pred.lane_bytes_batch`` packs every lane of the batch in
  one ``encode_codes_lanes`` call (the ``symbol_hist`` and
  ``huffman_encode`` kernels), returning host ``bytes``;
* the **host stage**, on one worker thread: container append + commit
  only.  It is handed host bytes (or, on the CPU, host tensors it packs
  itself, as the reference's host entropy stage does), never a CUDA
  tensor, so no CUDA call is made off the caller's thread.

Host work on batch *k* overlaps device work on batch *k+1*; in-flight work
is capped at one encoded batch, so at most two batches of working set are
alive, and the plan sizes batches at half the byte budget.

``MemTracker`` accounts the executor-owned buffers exactly (batch input,
payload leaves by their ``nbytes`` wherever they live, packed lanes,
reservoir), where process-level ``ru_maxrss`` is polluted by allocator
baselines.  Both land in the :class:`StreamReport`.

Spans (``repro_torch.obs``, off by default): ``stream.prepass`` once a
call with a relative bound; a batch's ``stream.read`` (``batch``,
``tiles``), ``stream.h2d``, ``stream.encode``, ``stream.pack`` (``lanes``;
on the worker where the host stage packs), ``stream.reservoir`` and the
caller's ``stream.wait`` on the host stage; the worker's
``stream.append`` (``lanes``: append, commit, fsync).

Fault tolerance (docs/ROBUSTNESS.md): the device encode and the host
append both run under a :class:`~repro_torch.runtime.fault.RetryPolicy`.
The retry scope of the device stage is ``encode_tiles`` only, as in the
reference; the copy back in ``lane_bytes_batch`` is outside it.  CUDA
errors are sticky, so a real one fails the retry again and leaves the
journaled partial behind; nothing falls back to the plain versions or the
CPU.  Each batch's lanes are journaled by :meth:`GWTCWriter.commit` once
appended, so an exhausted retry leaves a *resumable* partial container
(``resume=True`` picks up from the first uncommitted batch).  A writer on a
GWDS envelope's shared sink (``can_rollback`` False) cannot drop a
half-appended batch, so there each batch is appended once, with no retry:
a failed append fails the stream.
"""
from __future__ import annotations

import os
import resource
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import obs
from repro_torch.exec.plan import StreamPlan, plan_stream
from repro_torch.exec.sources import TileSource, as_source, value_range
from repro_torch.exec.writer import GWTCWriter
from repro_torch.kernels.ops import resolve_device
from repro_torch.runtime.fault import RetryPolicy


class MemTracker:
    """Byte accounting for executor-owned buffers (current + high-water)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.current = 0
        self.peak = 0

    def add(self, n: int) -> None:
        with self._lock:
            self.current += int(n)
            self.peak = max(self.peak, self.current)

    def sub(self, n: int) -> None:
        with self._lock:
            self.current -= int(n)


@dataclass
class StreamReport:
    """What a finished streaming compression did and what it cost."""

    path: str | None
    shape: tuple[int, ...]
    tile: tuple[int, ...]
    n_tiles: int
    n_batches: int
    batch_tiles: int
    nbytes: int
    eb_abs: float
    predictor: str
    backend: str
    mem_budget: int
    peak_tracked_bytes: int
    ru_maxrss_kb: int
    enhanced: bool = False
    reservoir_tiles: int = 0
    # fault-tolerance accounting: total retried attempts, the batch indices
    # that needed at least one retry, and how many batches a resume skipped
    retries: int = 0
    failed_batches: tuple[int, ...] = field(default_factory=tuple)
    resumed_batches: int = 0
    # entropy-stage accounting: whether lane packing ran in the device stage
    # and the wall time the host stage spent (with device entropy it is
    # container append + commit only)
    host_stage_s: float = 0.0
    entropy_device: bool = False
    # device programs this stream compiled: always 0 in the port, which has
    # no jit (kernels are built once per process, before any stream); kept
    # so reports compare field for field with the reference's
    programs_compiled: int = 0

    @property
    def peak_over_budget(self) -> float:
        return self.peak_tracked_bytes / max(self.mem_budget, 1)


def _resolve_eb_streaming(source: TileSource, rel_eb, abs_eb) -> float:
    """Streaming mirror of ``repro_torch.sz.quantizer.resolve_eb``: the same
    float32 range arithmetic (so streamed and eager artifacts agree on eb
    bit for bit), fed by a block prepass instead of a whole-volume
    reduction."""
    if (rel_eb is None) == (abs_eb is None):
        raise ValueError("pass exactly one of rel_eb / abs_eb")
    if rel_eb is not None:
        with obs.span("stream.prepass"):
            lo, hi = value_range(source)
        vrange = float(np.float32(hi) - np.float32(lo))
        abs_eb = rel_eb * max(vrange, float(np.finfo(np.float32).tiny))
        absmax = max(abs(lo), abs(hi))
        max_q = absmax / (2.0 * float(abs_eb))
        if max_q >= 2**30:
            raise ValueError(
                f"eb={abs_eb:g} too small for data magnitude (q={max_q:.3g} >= 2^30)")
    return float(abs_eb)


def _tile_bounds(i: int, grid, tile, shape):
    coord = np.unravel_index(i, grid)
    lo = tuple(int(c) * t for c, t in zip(coord, tile))
    hi = tuple(min(l + t, d) for l, t, d in zip(lo, tile, shape))
    return lo, hi


def _read_batch(source: TileSource, ids, plan: StreamPlan) -> np.ndarray:
    """[B, *tile] float32 batch, padded to the plan's uniform width by
    repeating the final tile (every batch has one shape)."""
    B = plan.batch_tiles
    out = np.empty((B,) + plan.tile, np.float32)
    for j, i in enumerate(ids):
        lo, hi = _tile_bounds(i, plan.grid, plan.tile, plan.shape)
        out[j] = source.read_tile(lo, hi, plan.tile)
    for j in range(len(ids), B):
        out[j] = out[len(ids) - 1]
    return out


def stream_compress(source, dest, *, tile=(64, 64, 64), rel_eb: float | None = None,
                    abs_eb: float | None = None, backend: str = "huffman+zlib",
                    predictor: str = "lorenzo", order: str = "cubic", max_levels: int = 5,
                    mem_budget: int = 256 << 20, enhance=None,
                    reservoir_tiles: int | None = None, shape=None,
                    retry: RetryPolicy | None = None, resume: bool = False,
                    injector=None, write_injector=None, device=None) -> StreamReport:
    """Compress a streamed volume into a ``GWTC`` v3 container.

    ``source`` is anything :func:`repro_torch.exec.sources.as_source`
    accepts; ``dest`` a path, a writable file object, or an already-open
    :class:`GWTCWriter`.  ``device`` (None: the CUDA device, which must
    exist) runs the device stage.  ``enhance`` optionally trains group-wise
    GWLZ enhancers on a reservoir sample of (recon, residual) tile pairs
    (the bounded-memory stand-in for the eager path's whole-volume training
    set) and attaches the model before the footer is written.  Returns a
    :class:`StreamReport`; open the artifact with ``api.open``.

    ``retry`` (default :class:`RetryPolicy()`) governs both the device
    encode and the host append; ``resume=True`` re-opens an interrupted
    path destination at its journaled commit point and streams only the
    uncommitted batches (the resumed container is byte-identical to an
    uninterrupted run).  ``injector`` / ``write_injector`` are
    :class:`~repro_torch.runtime.fault.FailureInjector` hooks for tests: the
    first fires per batch index inside the device encode, the second per
    global lane id inside the host append."""
    from repro_torch.sz.predictor import get_predictor
    from repro_torch.sz.tiled import normalize_tile

    device = resolve_device(device)
    retry = retry if retry is not None else RetryPolicy()
    src = as_source(source, shape=shape)
    tile = normalize_tile(tile, len(src.shape))
    eb = _resolve_eb_streaming(src, rel_eb, abs_eb)
    pred = get_predictor(predictor)
    levels = pred.plan(tile, max_levels)
    # on a card, lane packing moves into the device stage and the host stage
    # shrinks to container append + commit (the reference's rule: on an
    # accelerator, not on the CPU); bytes are identical either way
    device_entropy = device.type == "cuda"
    plan = plan_stream(src.shape, tile, mem_budget, predictor=predictor, levels=levels,
                       device_entropy=device_entropy)
    want = (plan.shape, plan.tile, eb, backend, predictor, order, levels)

    start_tile, resumed_batches = 0, 0
    if resume:
        if enhance:
            raise ValueError(
                "resume=True cannot train enhancers: the reservoir would sample only "
                "the re-streamed batches, so the attached model (and the container "
                "bytes) would depend on where the interruption fell; re-run without "
                "resume to enhance")
        if isinstance(dest, GWTCWriter) or hasattr(dest, "write"):
            raise ValueError("resume=True needs a path destination "
                             "(the commit journal lives next to the file)")
        writer, path = GWTCWriter.resume(dest), str(dest)
        aligned = plan.resume_point(writer.committed_lanes)
        if aligned != writer.committed_lanes:
            writer.truncate_lanes(aligned)  # mid-batch commit: redo the batch
        start_tile = aligned
        resumed_batches = start_tile // plan.batch_tiles
    elif isinstance(dest, GWTCWriter):
        # a pre-made writer already wrote its header; every header field must
        # agree with how the lanes will be encoded
        writer, path = dest, None
    else:
        path = None if hasattr(dest, "write") else str(dest)
        writer = GWTCWriter(dest, shape=plan.shape, tile=plan.tile, eb_abs=eb,
                            backend=backend, predictor=predictor, order=order, levels=levels)
    if resume or isinstance(dest, GWTCWriter):
        wrote = (writer.shape, writer.tile, writer.eb_abs, writer.backend,
                 writer.predictor, writer.order, writer.levels)
        if wrote != want:
            if resume:
                writer.abort()
            raise ValueError(
                f"writer header {wrote} does not match the encode settings {want} "
                "(shape, tile, eb_abs, backend, predictor, order, levels must agree)")

    reservoir = None
    if enhance:
        from repro_torch.core.trainer import GWLZTrainConfig, TileReservoir

        cfg = enhance if isinstance(enhance, GWLZTrainConfig) else GWLZTrainConfig()
        if reservoir_tiles is None:
            pair_bytes = 8 * int(np.prod(tile))  # f32 recon + f32 residual
            reservoir_tiles = max(4, (mem_budget // 4) // pair_bytes)
        reservoir = TileReservoir(int(reservoir_tiles), seed=cfg.seed)

    mem = MemTracker()
    pool = ThreadPoolExecutor(1, thread_name_prefix="gwtc-host")
    pending = None
    # retry accounting, shared between the caller's thread (device stage) and
    # the host worker: on_retry callbacks from both land here
    fault_lock = threading.Lock()
    retries = 0
    failed_batches: set[int] = set()

    def note_retry(bidx: int):
        def cb(_exc, _attempt):
            nonlocal retries
            with fault_lock:
                retries += 1
                failed_batches.add(bidx)
        return cb

    host_time_lock = threading.Lock()
    host_stage_s = 0.0

    def host_stage(payload, ids, bidx: int, nbytes_held: int, blobs=None) -> None:
        """``blobs`` set means the device stage already packed the lanes and
        the host stage is container append + commit only; otherwise (on the
        CPU) ``payload`` holds host tensors, packed here as the reference's
        host entropy stage does."""
        nonlocal host_stage_s
        t0 = time.perf_counter()
        try:
            if blobs is None:
                with obs.span("stream.pack", lanes=len(ids)):
                    blobs = pred.lane_bytes_batch(payload, len(ids), backend)

            def append_batch():
                if writer.can_rollback:
                    # drop any half-appended lanes from a previous attempt so
                    # the retry replays the whole batch from the commit point
                    writer.rollback_uncommitted()
                for j, lane in enumerate(blobs):
                    if write_injector is not None:
                        write_injector.maybe_fail(ids[j])
                    writer.append_lane(lane)
                writer.commit()

            with obs.span("stream.append", lanes=len(blobs)):
                if writer.can_rollback:
                    retry.run(append_batch, on_retry=note_retry(bidx))
                else:
                    append_batch()  # shared sink: no safe replay, fail fast
        finally:
            mem.sub(nbytes_held)
            with host_time_lock:
                host_stage_s += time.perf_counter() - t0

    try:
        for bidx, run in enumerate(plan.batches(start_tile), start=resumed_batches):
            ids = list(run)
            # the batch read stays OUTSIDE the retry scope: sources are
            # forward-only streams, a re-read is not generally possible
            with obs.span("stream.read", batch=bidx, tiles=len(ids)):
                batch = _read_batch(src, ids, plan)
            # the quantizer's overflow guard, applied to the data actually
            # seen (an abs_eb stream takes no range prepass)
            max_q = float(np.abs(batch[: len(ids)]).max()) / (2.0 * eb)
            if max_q >= 2**30:
                raise ValueError(
                    f"eb={eb:g} too small for data magnitude (q={max_q:.3g} >= 2^30)")
            mem.add(batch.nbytes)
            with obs.span("stream.h2d"):
                xb = torch.from_numpy(batch).to(device)

            def encode():
                if injector is not None:
                    injector.maybe_fail(bidx)
                return pred.encode_tiles(xb, eb, order=order, levels=levels)

            with obs.span("stream.encode"):
                payload, recon = retry.run(encode, on_retry=note_retry(bidx))
            held = sum(leaf.nbytes for leaf in payload.values())
            blobs = None
            if device_entropy:
                # the device stage packs the lanes actually written (not the
                # batch's repeat padding) and copies back bytes only
                with obs.span("stream.pack", lanes=len(ids)):
                    blobs = pred.lane_bytes_batch(payload, len(ids), backend)
                held += sum(len(b) for b in blobs)
            mem.add(held)
            if reservoir is not None:
                with obs.span("stream.reservoir"):
                    recon_np = recon[: len(ids)].cpu().numpy()
                    mem.add(recon_np.nbytes)
                    grew = reservoir.offer(recon_np, batch[: len(ids)] - recon_np)
                    mem.add(grew)
                    mem.sub(recon_np.nbytes)
                    del recon_np
            del recon, xb
            mem.sub(batch.nbytes)
            del batch
            if pending is not None:
                with obs.span("stream.wait"):
                    pending.result()  # cap in-flight host work at one batch
            pending = pool.submit(host_stage, None if device_entropy else payload, ids,
                                  bidx, held, blobs)
            del payload, blobs
        if pending is not None:
            with obs.span("stream.wait"):
                pending.result()
            pending = None

        enhanced = False
        if reservoir is not None and len(reservoir):
            from repro_torch.core.pipeline import serialize_model
            from repro_torch.core.trainer import train_enhancers_streamed

            model, _hist = train_enhancers_streamed(reservoir, cfg, device=device)
            writer.extras["gwlz"] = serialize_model(model)
            enhanced = True
        nbytes = writer.finalize()
    except BaseException:
        if pending is not None:  # drain the worker before touching the sink
            try:
                pending.result()
            # the worker can only fail the ways the append path fails; a
            # propagating exception here would mask the original error
            except (OSError, RuntimeError, ValueError):
                pass
            pending = None
        if not isinstance(dest, GWTCWriter):
            journaled = writer._journal_path is not None
            writer.abort()  # close the fd; no footer = detectably truncated
            if path is not None and not journaled:
                try:
                    os.unlink(path)  # don't leave a garbage container behind
                except OSError:
                    pass
            # journaled path dests keep the partial container + journal on
            # disk: that pair is exactly what resume=True needs
        raise
    finally:
        pool.shutdown(wait=True)
        src.close()

    return StreamReport(
        path=path, shape=plan.shape, tile=plan.tile, n_tiles=plan.n_tiles,
        n_batches=plan.n_batches, batch_tiles=plan.batch_tiles, nbytes=nbytes,
        eb_abs=eb, predictor=predictor, backend=backend,
        mem_budget=int(mem_budget), peak_tracked_bytes=mem.peak,
        ru_maxrss_kb=int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss),
        enhanced=enhanced,
        reservoir_tiles=len(reservoir) if reservoir is not None else 0,
        retries=retries,
        failed_batches=tuple(sorted(failed_batches)),
        resumed_batches=resumed_batches,
        host_stage_s=host_stage_s,
        entropy_device=device_entropy,
    )
