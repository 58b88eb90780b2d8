"""Spans and counters of one request, on the clock of ``torch.profiler``.

A ``Recorder`` holds one request's spans and counters; it is the request's
identifier.  ``engine.run_round`` and ``engine.run_stream`` make one per
request and make it the current one (``recording``) while the request's
work runs; ``span(name)`` and ``count(name, n)`` write to the current
recorder, so that the layers below (``ops/segmented``, ``parallel/mesh``)
record without being handed it.  With no request in flight, as when a test
or a tool calls the tracker directly, ``span`` returns one shared null
context and ``count`` returns at once.

A span is ``(name, start_ns, end_ns, parent)``: the parent is the index of
the innermost span open when it started (-1 for none).  A layer's self time
is its span's duration less the part its children cover.  The stamps are
``perf_counter_ns`` plus one offset to ``time_ns`` taken when the recorder
is made: durations on a monotonic clock, positions on CLOCK_REALTIME, which
is the clock of the Kineto events that ``torch.profiler`` records, so that
a trace's device intervals fall inside the spans of the work that queued
them.  ``record_function`` is not used: Kineto would mirror each range onto
the device's timeline, where a reader of the trace would count it as a
device operation.

``finished`` keeps the spans and counters of the last ``KEEP`` rounds
that ``run_round`` finished, oldest first, for a reader that sees only
what the rounds' callers kept of their results (a benchmark's or a
monitor's, in the same process); ``keep`` appends one.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import time

KEEP = 1024  # rounds in ``finished``; some 6 kB each
_NULL = contextlib.nullcontext()
_current: contextvars.ContextVar = contextvars.ContextVar("spans_recorder",
                                                          default=None)


class _Span:
    """A span of a recorder as a context manager; ``__enter__`` returns
    its index."""

    __slots__ = ("rec", "name", "i")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> int:
        self.i = self.rec.open(self.name)
        return self.i

    def __exit__(self, *exc) -> None:
        self.rec.close(self.i)


class Recorder:
    """One request's spans (``[name, start_ns, end_ns, parent]`` lists
    until ``spans_out``) and counters."""

    def __init__(self):
        self._offset = time.time_ns() - time.perf_counter_ns()
        self.spans: list = []
        self.counts: dict = {}
        self._top = -1         # the innermost open span

    def now(self) -> int:
        return time.perf_counter_ns() + self._offset

    def open(self, name: str) -> int:
        """Opens a span now, inside the innermost open one; returns its
        index."""
        self.spans.append([name, self.now(), 0, self._top])
        self._top = len(self.spans) - 1
        return self._top

    def close(self, i: int) -> None:
        """Closes span i now; its parent is the innermost open span again."""
        s = self.spans[i]
        s[2] = self.now()
        self._top = s[3]

    def ns(self, i: int) -> int:
        """Span i's duration."""
        return self.spans[i][2] - self.spans[i][1]

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def spans_out(self) -> list:
        return [tuple(s) for s in self.spans]


finished: collections.deque = collections.deque(maxlen=KEEP)


def keep(rec: Recorder) -> tuple:
    """(spans, counters) of a finished request, appended to ``finished``."""
    out = (rec.spans_out(), rec.counts)
    finished.append(out)
    return out


@contextlib.contextmanager
def recording(rec: Recorder):
    """``rec`` is the current recorder inside the block."""
    token = _current.set(rec)
    try:
        yield rec
    finally:
        _current.reset(token)


def span(name: str):
    """A span of the current request, or a null context without one."""
    rec = _current.get()
    return _NULL if rec is None else _Span(rec, name)


def ns(i: int) -> int:
    """Span i's duration in the current request."""
    return _current.get().ns(i)


def count(name: str, n: int = 1) -> None:
    """Adds n to the current request's counter ``name``."""
    rec = _current.get()
    if rec is not None:
        rec.count(name, n)
