"""Spans of the program's host stages, on the device trace's clock.

``with span("entropy.fit"):`` marks a stage; ``with op("compress"):`` opens
a request: every span inside it carries the request's id.  The recorder is
off unless :func:`enable` turned it on:

* **off** (the default): :func:`span` tests one module flag and returns a
  shared no-op context.  It reads no clock and records nothing.
* **on**: each span appends one :class:`Record` to a list of its thread,
  timed by ``time.perf_counter_ns()``; :func:`take` returns every thread's
  records and clears them.  Counts ride on the span that did the work, as
  attributes (``span("entropy.encode", lanes=512)``, or ``s.set(hit=True)``
  inside the block).  While a ``torch.profiler`` runs, the span also opens
  a profiler range of its name, so the profiler's host events (and the
  idle gaps a trace names by them) carry the program's stages on the
  profiler's own clock.

The range is a ``cpu_op`` (``_RecordFunctionFast``), not a
``user_annotation`` (``record_function``): the profiler mirrors a user
annotation onto the device timeline over the kernels it launched, and
that mirror would read as device work in a busy-time union.
"""
from __future__ import annotations

import contextvars
import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch

_ON = False
_IDS = itertools.count(1)  # span and request ids; next() is atomic in CPython
_PARENT: contextvars.ContextVar[int] = contextvars.ContextVar("obs_parent", default=0)
_OP: contextvars.ContextVar[int] = contextvars.ContextVar("obs_op", default=0)
_LOCAL = threading.local()
_LISTS: list[tuple[threading.Thread, list]] = []  # every thread's records, for take()
_LISTS_LOCK = threading.Lock()


class Record(NamedTuple):
    """One finished span: ``parent`` is the enclosing span's id (0 at the
    top), ``op`` the request's id (0 outside any :func:`op`)."""

    name: str
    t0_ns: int
    t1_ns: int
    id: int
    parent: int
    thread: int
    op: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


class _Off:
    """The shared context of every span while the recorder is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


_OFF = _Off()


def _records() -> list:
    got = getattr(_LOCAL, "records", None)
    if got is None:
        got = _LOCAL.records = []
        with _LISTS_LOCK:
            _LISTS.append((threading.current_thread(), got))
    return got


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "token", "prof", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Attributes known only inside the block (a cache hit, a count)."""
        self.attrs.update(attrs)

    def _open(self, t0_ns: int) -> "_Span":
        self.id = next(_IDS)
        self.parent = _PARENT.get()
        self.token = _PARENT.set(self.id)
        self.prof = None
        if torch._C._autograd._profiler_enabled():
            self.prof = torch._C._profiler._RecordFunctionFast(self.name)
            self.prof.__enter__()
        self.t0 = t0_ns
        return self

    def _close(self, t1_ns: int, exc) -> None:
        if self.prof is not None:
            self.prof.__exit__(*exc)
        _PARENT.reset(self.token)
        _records().append(Record(self.name, self.t0, t1_ns, self.id, self.parent,
                                 threading.get_ident(), _OP.get(), self.attrs))

    def __enter__(self) -> "_Span":
        return self._open(time.perf_counter_ns())

    def __exit__(self, *exc) -> None:
        self._close(time.perf_counter_ns(), exc)


def span(name: str, **attrs):
    """A context manager that records the block as span ``name`` (with
    ``attrs``) while the recorder is on; a shared no-op while it is off."""
    if not _ON:
        return _OFF
    return _Span(name, attrs)


def spanned(name: str):
    """Decorator form of :func:`span`: every call of the function is span
    ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)

        return call

    return wrap


class _Op:
    __slots__ = ("span", "token")

    def __init__(self, kind: str):
        self.span = _Span("op." + kind, {})

    def __enter__(self) -> _Span:
        self.token = _OP.set(next(_IDS)) if _OP.get() == 0 else None
        return self.span.__enter__()

    def __exit__(self, *exc) -> None:
        self.span.__exit__(*exc)
        if self.token is not None:
            _OP.reset(self.token)


def op(kind: str):
    """A request's root span ``op.<kind>``.  The outermost ``op`` of a
    thread opens a request id that every span inside it carries; a nested
    one records its span under the same id."""
    if not _ON:
        return _OFF
    return _Op(kind)


class timed:
    """``with timed("gwlz.train", clock) as t:`` times the block by two calls
    of ``clock()`` (host seconds on ``time.perf_counter``'s clock; a caller's
    clock may first wait for the device) and leaves the difference in
    ``t.seconds``.  The block's own timing, kept with the recorder off too;
    while it is on, span ``name`` is recorded from the same two reads."""

    __slots__ = ("name", "clock", "attrs", "span", "t0", "seconds")

    def __init__(self, name: str, clock):
        self.name, self.clock, self.attrs = name, clock, {}
        self.seconds = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "timed":
        self.t0 = round(self.clock() * 1e9)
        self.span = _Span(self.name, self.attrs)._open(self.t0) if _ON else None
        return self

    def __exit__(self, *exc) -> None:
        # after a failure, no wait for the device: its error belongs to the caller
        t1 = round((self.clock() if exc[0] is None else time.perf_counter()) * 1e9)
        self.seconds = (t1 - self.t0) / 1e9
        if self.span is not None:
            self.span._close(t1, exc)


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def take() -> list[Record]:
    """Every thread's finished records, in the order they ended within a
    thread; the recorder keeps none of them (nor the lists of threads that
    have ended)."""
    out, live = [], []
    with _LISTS_LOCK:
        for thread, recs in _LISTS:
            if thread.is_alive():  # asked first: an ended thread appends nothing more
                live.append((thread, recs))
            n = len(recs)  # a record appended meanwhile stays for the next take
            out.extend(recs[:n])
            del recs[:n]
        _LISTS[:] = live
    return out
