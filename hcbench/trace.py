"""Tracing a window's first seconds, and reading the trace: device busy
time, device time per request and by kernel, and the idle gaps by what the
host was doing.

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


def union_us(intervals):
    """Total length of the union of (start, end) intervals: a copy of
    ``_union_us`` in ``tools/profile_torch_round.py`` (commit
    e13ae2fbc8b3)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


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
    requests: int          # the window's first requests, which were traced
    window_s: float        # the traced window's length
    busy_s: float          # union of the device operations' intervals in it
    device_s: dict         # request index -> {kernel name: device seconds}
    device_ops: list       # [[name, seconds]]: the TOP names by device time
    idle_gaps: list        # [[host activity, seconds]]: idle time by it


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(session: Session) -> Trace:
    """The Trace of a stopped session."""
    events = session.prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    requests = []          # (start, end, index)
    host = []              # (start, end, name): the host's own operations
    device = []            # (start, end, name)
    for e in events:
        name = e.name()
        s, t = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() == cuda:
            # Kineto mirrors each range onto the device's timeline: a
            # label, not an operation.
            if not name.startswith("hcbench."):
                device.append((s, t, name))
        elif name == WINDOW:
            window = (s, t)
        elif name.startswith(REQUEST):
            requests.append((s, t, int(name[len(REQUEST):])))
        else:
            host.append((s, t, name))
    if window is None:
        raise RuntimeError(f"the profile has no {WINDOW} range")
    w0, w1 = window
    device = [d for d in device if d[0] >= w0 and d[1] <= w1]
    requests.sort()
    starts = [r[0] for r in requests]
    device_s: dict = defaultdict(lambda: defaultdict(float))
    by_name: dict = defaultdict(float)
    for s, t, name in device:
        by_name[name] += t - s
        j = bisect.bisect_right(starts, s) - 1
        if j >= 0 and t <= requests[j][1]:
            device_s[requests[j][2]][name] += t - s
    busy = _merged([(s, t) for s, t, _ in device])
    return Trace(
        requests=session.requests,
        window_s=w1 - w0,
        busy_s=union_us([(s, t) for s, t, _ in device]),
        device_s={i: dict(v) for i, v in device_s.items()},
        device_ops=[[n[:NAME], v] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=_idle_by_host(busy, w0, w1, host))


def _idle_by_host(busy, w0, w1, host) -> list:
    """The device's idle time in the window, summed by the host operation
    under way at each gap's midpoint (the innermost, i.e. latest started,
    that covers it; "python" where none does: the host between operations)."""
    gaps, prev = [], w0
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
