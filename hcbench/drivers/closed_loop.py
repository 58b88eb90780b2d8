"""Closed loop: one client sends the pool's views one after another.

The client is a SLAM front end that has lost tracking and waits for the
pose: request i is view ``pool[i % len(pool)]`` with its own RANSAC sampling
seed, sent when request i - 1 has returned.  The window closes at the first
return after ``seconds``; at least one request is sent.
"""

from __future__ import annotations

import time

from hcbench import views


def drive(serve, pool: list, seed: int, seconds: float, traffic: dict,
          annotate) -> tuple:
    """(records, window seconds): ``serve(i, view, sampling seed)`` for each
    request inside ``annotate(i)``, a context manager for tracing."""
    if int(traffic.get("clients", 1)) != 1:
        raise ValueError("the closed loop has one client")
    records = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while not records or time.perf_counter() < deadline:
        with annotate(i):
            records.append(serve(i, pool[i % len(pool)],
                                 views.request_seed(seed, i)))
        i += 1
    return records, time.perf_counter() - t0
