"""Spans and counters of the program's own layers, for profiling runs.

Off by default.  :func:`enable` turns it on and :func:`disable` off,
:func:`reset` clears what it holds and :func:`snapshot` returns it;
nothing else turns it on.  While off, :func:`span` returns one shared
object that does nothing and :func:`count` returns at once.

While on, each span records its name, its attributes, its start and end,
the index of its parent span and the request it belongs to, in a list in
memory (nothing is written anywhere), and opens a profiler range named
``repro.<name>``: inside a profiled window the span lands on the
profiler's timeline beside the device's events.  The range is the
profiler's fast record-function (``_RecordFunctionFast``): the host event
``torch.profiler.record_function`` makes, at 0.6 µs an entry and exit
against 11 µs (the host of an H100 machine), with no copy on the device's
timeline, and stamped near the end of its entry and the start of its
exit.  Times are ``time.time_ns()``, the Unix-epoch clock the profiler's
host events carry, read just after the range opens and just before it
closes, so a span and its ``repro.*`` event agree to a few microseconds.
A span adds no sync: around work queued on the device, its host duration
is the time to queue it, and its device time is read from the profiler's
trace.

Requests: the span opened with ``request=True`` (``Coordinator.invoke``'s
root) starts a new request; a span opened inside another belongs to its
parent's request, and one opened outside any (``Coordinator.release``)
to the last request started.  The coordinator serves one call at a time.

Counters (:func:`count`) live here, apart from ``Network.meter``,
``ModelInstance.stats``, the pools' meters and the kernel layer's counts,
which tests hold equal to the reference's.  Inside :func:`taped`, counts
go to a tape instead, whether tracing is on or off: the decode step's
CUDA graph (``serving/graph.py``) tapes its capture and adds the tape
again at each replay.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import Counter
from typing import Dict, List, Optional

from torch._C._profiler import _RecordFunctionFast

PREFIX = "repro."            # the profiler's name of span ``x``: repro.x


@dataclasses.dataclass(slots=True)
class Span:
    """One span; times in ns (``end_ns`` None while its work runs)."""

    name: str
    start_ns: int
    parent: int                  # index of the parent span, -1 at a root
    request: Optional[int]
    attrs: dict
    end_ns: Optional[int] = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


_on = False
_spans: List[Span] = []
_open: List[int] = []          # indices of the spans open now, innermost last
_counters: Counter = Counter()
_requests = 0                  # requests started since the last reset
_last_request: Optional[int] = None
_tape: Optional[Counter] = None     # where counts go inside taped()


class _Nothing:
    """The span while tracing is off: one shared object, doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


NOTHING = _Nothing()


class _Recording:
    __slots__ = ("name", "request", "attrs", "span", "range")

    def __init__(self, name: str, request: bool, attrs: dict):
        self.name, self.request, self.attrs = name, request, attrs

    def __enter__(self):
        global _requests, _last_request
        parent = _open[-1] if _open else -1
        if self.request:
            rid = _last_request = _requests
            _requests += 1
        elif parent >= 0:
            rid = _spans[parent].request
        else:
            rid = _last_request
        self.range = _RecordFunctionFast(PREFIX + self.name)
        self.range.__enter__()
        self.span = Span(self.name, time.time_ns(), parent, rid, self.attrs)
        _open.append(len(_spans))
        _spans.append(self.span)
        return self

    def __exit__(self, *exc) -> None:
        self.span.end_ns = time.time_ns()
        self.range.__exit__(*exc)
        if _open and _spans[_open[-1]] is self.span:   # not reset meanwhile
            _open.pop()
        return None


def span(name: str, request: bool = False, **attrs):
    """A context manager around one layer's work: ``name`` (its profiler
    range is ``repro.<name>``) and ``attrs`` (pages, bytes, tokens) go on
    the record; ``request=True`` starts a new request."""
    if not _on:
        return NOTHING
    return _Recording(name, request, attrs)


def count(name: str, n: int) -> None:
    """Add ``n`` (a host integer: no device value is read) to counter
    ``name``; inside :func:`taped`, to its tape instead."""
    if _tape is not None:
        _tape[name] += n
    elif _on:
        _counters[name] += n


@contextlib.contextmanager
def taped():
    """Counts made inside, on or off, go to the ``Counter`` this yields and
    not to the counters: a CUDA graph's capture records what each replay
    adds again with :func:`count`."""
    global _tape
    outer, _tape = _tape, Counter()
    try:
        yield _tape
    finally:
        _tape = outer


def enable() -> None:
    """Turn tracing on.  The first profiler range of a process pays a
    one-time set-up; one empty range here pays it, so that no span's start
    lags its event by that much."""
    global _on
    with _RecordFunctionFast(PREFIX + "enable"):
        pass
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every span, counter and request (a span open now closes
    unrecorded)."""
    global _requests, _last_request
    _spans.clear()
    _open.clear()
    _counters.clear()
    _requests, _last_request = 0, None


def snapshot() -> Dict[str, object]:
    """The spans in the order they opened (a span's ``parent`` is an index
    into this list, -1 at a root; one still open has ``end_ns`` None) and
    the counters."""
    return {"spans": list(_spans), "counters": dict(_counters)}
