"""Fault tolerance: retry policies, heartbeats, stragglers, restart; port
of ``repro/runtime/fault.py``.

:class:`RetryPolicy` is the shared transient-failure contract: the
streaming compression executor (``repro_torch.exec.executor``) runs its
device encode and its host append under one, and :class:`FailureInjector`
drives deterministic fault schedules through the same code paths in tests.
:class:`ResilientLoop` is the checkpoint/restart training driver:
deterministic step boundaries, periodic checkpoints through a
:class:`~repro_torch.checkpoint.CheckpointManager`, restore-and-replay
after a failure; :class:`HeartbeatMonitor` takes its step times and names
stragglers.  The reference's jittered backoff and its ``dead()`` liveness
check wait for a caller that sets them (its ``launch/train.py``, not
ported): every retry in the port backs off without jitter.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass(frozen=True)
class RetryPolicy:
    """How many times to retry a transient failure, and how long to wait.

    ``run(fn)`` calls ``fn`` up to ``max_attempts`` times, sleeping
    ``backoff * 2**attempt`` seconds between attempts (exponential; the
    reference's delays at its default ``jitter=0``).  Only exceptions in
    ``retry_on`` are retried; anything else (a programming error, a
    corrupt-input ValueError) propagates on the first attempt.  The caller
    observes every retry through ``on_retry(exc, attempt)``; ``sleep`` is
    injectable so tests run without wall-clock delays."""

    max_attempts: int = 3
    backoff: float = 0.05
    retry_on: tuple[type[BaseException], ...] = (RuntimeError, OSError)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")

    def delay(self, attempt: int) -> float:
        """Seconds to wait after failed attempt ``attempt`` (0-based)."""
        return self.backoff * (2.0 ** attempt)

    def run(self, fn: Callable, *, on_retry: Callable | None = None,
            sleep: Callable[[float], None] = time.sleep):
        """``fn()`` with retries; returns its result or raises the last error."""
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except self.retry_on as e:
                if attempt + 1 >= self.max_attempts:
                    raise
                if on_retry is not None:
                    on_retry(e, attempt)
                sleep(self.delay(attempt))
        raise AssertionError("unreachable")  # pragma: no cover


@dataclass
class HeartbeatMonitor:
    """Per-worker step heartbeats with median-based straggler detection: a
    worker whose recent median step time exceeds ``straggler_factor`` times
    the median of all workers' medians is a straggler."""

    n_workers: int
    straggler_factor: float = 3.0
    window: int = 16
    _times: dict[int, list[float]] = field(default_factory=dict)

    def beat(self, worker: int, step_duration: float) -> None:
        self._times.setdefault(worker, []).append(step_duration)
        if len(self._times[worker]) > self.window:
            self._times[worker] = self._times[worker][-self.window:]

    def stragglers(self) -> list[int]:
        if len(self._times) < self.n_workers:
            return []  # a worker with no heartbeat is dead, not slow
        med = np.median([np.median(v) for v in self._times.values()])
        return [w for w, v in self._times.items()
                if np.median(v[-4:]) > self.straggler_factor * max(med, 1e-9)]


class FailureInjector:
    """Deterministic fault injection for tests: raise at given steps.

    ``fail_at`` names the steps (batch ids, lane ids: whatever the
    instrumented code passes) that fail; each fires ``attempts`` times
    before succeeding, so a schedule can model a transient blip
    (``attempts=1``, survived by one retry) or a hard fault
    (``attempts >= RetryPolicy.max_attempts``, exhausting the policy).
    ``exc`` picks the raised type (e.g. ``OSError`` for an append-path
    fault): an exception class or a ``step -> exception`` factory."""

    def __init__(self, fail_at: set[int], *, exc=RuntimeError, attempts: int = 1):
        self.fail_at = set(fail_at)
        self.exc = exc
        self.attempts = int(attempts)
        self.failed: dict[int, int] = {}  # step -> times fired

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and self.failed.get(step, 0) < self.attempts:
            self.failed[step] = self.failed.get(step, 0) + 1
            if isinstance(self.exc, type) and issubclass(self.exc, BaseException):
                raise self.exc(f"injected failure at step {step} "
                               f"(attempt {self.failed[step]})")
            raise self.exc(step)


@dataclass
class ResilientLoop:
    """Checkpoint/restart training loop.

    ``step_fn(state, batch) -> (state, metrics)`` must be deterministic
    given (state, batch), and ``batch_fn(step)`` addresses batches by step
    index, so a replay after a restore repeats the lost steps exactly.
    ``run`` resumes from the manager's latest checkpoint, saves every
    ``ckpt_every`` steps, and on a :class:`RuntimeError` restores the
    latest checkpoint and replays from its step; more than
    ``max_restarts`` failures re-raise.  With no checkpoint yet it restarts
    at step 0 from the state as it stands, as the reference does.

    A step may update the state's tensors in place: ``manager.save``
    copies every leaf before it returns, and a restore builds new tensors.
    ``torch.cuda.OutOfMemoryError`` is a RuntimeError, and a restart after
    one is fine.  A device-side assert also surfaces as a RuntimeError,
    but it leaves the CUDA context unusable: no in-process restart
    recovers it, so the replay fails again until ``max_restarts`` is spent
    and the error propagates; restart the process instead."""

    step_fn: Callable
    batch_fn: Callable  # step -> batch
    manager: object  # a repro_torch.checkpoint.CheckpointManager
    ckpt_every: int = 50
    max_restarts: int = 8

    def run(self, state, n_steps: int, *, injector: FailureInjector | None = None,
            monitor: HeartbeatMonitor | None = None):
        """Returns (state, per-step metrics including replayed steps, restarts)."""
        metrics_log = []
        restarts = 0
        step = 0
        latest = self.manager.latest_step()
        if latest is not None:  # resume
            state = self.manager.restore(state, latest)
            step = latest
        while step < n_steps:
            try:
                t0 = time.time()
                if injector is not None:
                    injector.maybe_fail(step)
                batch = self.batch_fn(step)
                state, m = self.step_fn(state, batch)
                if monitor is not None:
                    monitor.beat(0, time.time() - t0)
                metrics_log.append(m)
                step += 1
                if step % self.ckpt_every == 0:
                    self.manager.save(step, state)
            except RuntimeError:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                self.manager.wait()  # an async save in flight publishes first
                latest = self.manager.latest_step()
                if latest is None:
                    step = 0  # cold restart
                    continue
                state = self.manager.restore(state, latest)
                step = latest
        self.manager.wait()
        return state, metrics_log, restarts
