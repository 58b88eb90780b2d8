"""Tracing a window's first seconds, and reading the trace: device busy
time, device time per request and by kernel, and the idle gaps by what the
host was doing, each card's on its own in a cell of several.

``Session`` runs ``torch.profiler`` with CPU and CUDA activities from the
window's start to the first request boundary after ``TRACE_SECONDS``, and
marks that traced part and each request in it with ``record_function``
ranges named ``hcbench.window`` and ``hcbench.request.<i>``.  (A whole
51-second window of the host-bound abort round holds some six million
events, whose reading alone took about three minutes of a run's six.)  A
request's call returns only with its pose on the host, so every device
operation it queued ran inside its range: an operation is the request's if
its interval lies in the request's range.  The events are read from the
profiler's raw Kineto results.

A cell of several cards reads each card's events apart (Kineto's
``device_index``): its busy intervals are merged card by card, its busy
time is the mean card's, and its idle gaps are each card's, summed by the
host's activity.  A cell of one card reads every device event as its
card's.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from collections import defaultdict

import numpy as np
import torch

WINDOW = "hcbench.window"
REQUEST = "hcbench.request."
TRACE_SECONDS = 15.0  # the traced part of a window
TOP = 10  # entries of each breakdown list
NAME = 96  # characters of an operation's name kept in the breakdown


class Session:
    """The profiler over the first ``TRACE_SECONDS`` of a window: started
    here, ``annotate(i)`` marks request i, and the profile stops after the
    first request that ends past ``TRACE_SECONDS`` (or at ``stop``)."""

    def __init__(self, cuda: bool, sync):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._range = record_function
        self._sync = sync
        self.prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
        self.prof.start()
        self._window = record_function(WINDOW)
        self._window.__enter__()
        self._t0 = time.perf_counter()
        self.requests = 0  # the requests traced, the window's first
        self.on = True

    @contextlib.contextmanager
    def annotate(self, i: int):
        if not self.on:
            yield
            return
        with self._range(f"{REQUEST}{i}"):
            yield
        self.requests = i + 1
        if time.perf_counter() - self._t0 >= TRACE_SECONDS:
            self.stop()

    def stop(self) -> None:
        if self.on:
            self._sync()
            self._window.__exit__(None, None, None)
            self.prof.stop()
            self.on = False


@dataclasses.dataclass
class Trace:
    """A traced window; device times are summed over the cards."""

    requests: int          # the window's first requests, which were traced
    window_s: float        # the traced window's length
    busy_s: float          # the mean card's union of its operations in it
    device_s: dict         # request index -> {kernel name: device seconds}
    device_ops: list       # [[name, seconds]]: the TOP names by device time
    idle_gaps: list        # [[host activity, seconds]]: idle time by it
    # Per card, its operations' merged intervals [[start, end]] (seconds).
    busy: list = dataclasses.field(default_factory=list)


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(session: Session, chips: int = 1) -> Trace:
    """The Trace of a stopped session of a cell of ``chips`` cards."""
    events = session.prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    requests = []          # (start, end, index)
    host = []              # (start, end, name): the host's own operations
    cards = defaultdict(list)  # card -> [(start, end, name)]
    for e in events:
        name = e.name()
        s, t = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() == cuda:
            # Kineto mirrors each range onto the device's timeline: a
            # label, not an operation.
            if not name.startswith("hcbench."):
                cards[e.device_index() if chips > 1 else 0].append(
                    (s, t, name))
        elif name == WINDOW:
            window = (s, t)
        elif name.startswith(REQUEST):
            requests.append((s, t, int(name[len(REQUEST):])))
        else:
            host.append((s, t, name))
    if window is None:
        raise RuntimeError(f"the profile has no {WINDOW} range")
    w0, w1 = window
    # A card without an operation in the window is idle all through it.
    cards = [[d for d in cards[c] if d[0] >= w0 and d[1] <= w1]
             for c in sorted(set(range(chips)) | set(cards))]
    device = [d for card in cards for d in card]
    requests.sort()
    starts = [r[0] for r in requests]
    device_s: dict = defaultdict(lambda: defaultdict(float))
    by_name: dict = defaultdict(float)
    for s, t, name in device:
        by_name[name] += t - s
        j = bisect.bisect_right(starts, s) - 1
        if j >= 0 and t <= requests[j][1]:
            device_s[requests[j][2]][name] += t - s
    busy = [_merged([(s, t) for s, t, _ in card]) for card in cards]
    return Trace(
        requests=session.requests,
        window_s=w1 - w0,
        busy_s=sum(e - s for card in busy for s, e in card) / chips,
        device_s={i: dict(v) for i, v in device_s.items()},
        device_ops=[[n[:NAME], v] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=_idle_by_host(busy, w0, w1, host),
        busy=busy)


def _idle_by_host(cards, w0, w1, host) -> list:
    """The cards' idle time in the window (each card's merged busy
    intervals in ``cards``), summed by the host operation under way at each
    gap's midpoint (the innermost, i.e. latest started, that covers it;
    "python" where none does: the host between operations)."""
    gaps = []
    for busy in cards:
        prev = w0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if w1 > prev:
            gaps.append((prev, w1))
    host.sort()
    hs = np.array([h[0] for h in host])
    he = np.array([h[1] for h in host])
    totals: dict = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        j = int(np.searchsorted(hs, mid, side="right")) - 1
        label = "python"
        for k in range(j, max(j - 64, -1), -1):
            if he[k] >= mid:
                label = host[k][2]
                break
        totals[label] += b - a
    return [[n[:NAME], v] for n, v in sorted(totals.items(),
                                             key=lambda kv: -kv[1])[:TOP]]
