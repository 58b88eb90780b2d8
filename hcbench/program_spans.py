"""Reading the program's own spans and counters for the per-layer metrics.

The program keeps the spans and counters of its last rounds in
``utils/spans.finished``, oldest first (``RoundResult.spans`` and
``counts`` of each ``run_round``), in the benchmark's process.  The
window's requests are the last rounds the program ran when the readers
run, one round each, in order, so the log's tail is laid over the run's
requests from their end; a request that the log no longer reaches has
none.  Each pairing is checked: a request's ``track_ms`` is its
``round.track`` span's duration, to the digit.  A program without the log
(an older commit), or a log that does not pair so, gives no spans, and
every reader then returns None.

A span is ``(name, start_ns, end_ns, parent)``, its stamps on the clock of
the profiler's events (CLOCK_REALTIME), so that a trace's merged device
intervals (seconds; ``Busy``) can be laid over them.
"""

from __future__ import annotations

import bisect
import itertools


def _log() -> list:
    try:
        from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
            spans,
        )
        return list(spans.finished)
    except (ImportError, AttributeError):
        return []


def _track_ms(spans: list):
    return next(((e - s) * 1e-6 for name, s, e, _ in spans
                 if name == "round.track"), None)


def rounds(run) -> list:
    """Per request of the run, its (spans, counters) from the program's log,
    or None where the log does not reach it; all None where the program
    keeps no log or the log does not pair with the requests."""
    reqs = run.requests
    tail = _log()[-len(reqs):]
    out = [None] * (len(reqs) - len(tail)) + tail
    for r, kept in zip(reqs, out):
        if kept is not None and r.error is None and (
                _track_ms(kept[0]) != r.track_ms):
            return [None] * len(reqs)
    return out


def untraced(run) -> list:
    """The (spans, counters) of the requests that ran after the profiler
    stopped, where it added nothing to the host's time; of every request
    where none ran after it (a run whose whole window was traced) or in a
    run that was not traced.  Requests that raised, or that the log does
    not reach, are left out."""
    kept = [k if r.error is None else None
            for r, k in zip(run.requests, rounds(run))]
    n = run.trace.requests if run.trace is not None else 0
    after = [k for k in kept[n:] if k is not None]
    return after or [k for k in kept if k is not None]


def ms_per_view(kept: list, names) -> float:
    """The summed durations of the spans named ``names``, ms per request,
    or None for no request."""
    if not kept:
        return None
    ns = sum(e - s for spans, _ in kept for name, s, e, _ in spans
             if name in names)
    return ns * 1e-6 / len(kept)


class Busy:
    """The device's busy time inside any interval: merged, ordered busy
    intervals [[start, end]] (seconds) and their running sums."""

    def __init__(self, busy: list):
        self.s = [b[0] for b in busy]
        self.e = [b[1] for b in busy]
        self.cum = [0.0] + list(itertools.accumulate(
            e - s for s, e in zip(self.s, self.e)))

    def within(self, a: float, b: float) -> float:
        i = bisect.bisect_right(self.e, a)   # the first ending after a
        j = bisect.bisect_left(self.s, b)    # past the last starting before b
        if b <= a or j <= i:
            return 0.0
        return (self.cum[j] - self.cum[i] - max(0.0, a - self.s[i])
                - max(0.0, self.e[j - 1] - b))


def self_idle(spans: list, busy: Busy) -> list:
    """Per span, the device's idle time (seconds) that the span covers and
    none of its children does: each idle instant goes to the innermost span
    that covers it (a span's children lie inside it, one after another)."""
    idle = [(e - s) * 1e-9 - busy.within(s * 1e-9, e * 1e-9)
            for _, s, e, _ in spans]
    own = list(idle)
    for i, (_, _, _, parent) in enumerate(spans):
        if parent >= 0:
            own[parent] -= idle[i]
    return own
