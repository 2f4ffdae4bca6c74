"""Fault tolerance: retry policies and deterministic fault injection, port
of ``repro/runtime/fault.py``.

:class:`RetryPolicy` is the shared transient-failure contract: the
streaming compression executor (``repro_torch.exec.executor``) runs its
device encode and its host append under one, and :class:`FailureInjector`
drives deterministic fault schedules through the same code paths in tests.
The reference's ``HeartbeatMonitor``, ``RetryPolicy.jitter`` and
``ResilientLoop`` come with their caller, the checkpointed training loop
(ROADMAP.md Queue 1 item 9).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class RetryPolicy:
    """How many times to retry a transient failure, and how long to wait.

    ``run(fn)`` calls ``fn`` up to ``max_attempts`` times, sleeping
    ``backoff * 2**attempt`` seconds between attempts (exponential).  Only
    exceptions in ``retry_on`` are retried; anything else (a programming
    error, a corrupt-input ValueError) propagates on the first attempt.
    The caller observes every retry through ``on_retry(exc, attempt)``;
    ``sleep`` is injectable so tests run without wall-clock delays."""

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
