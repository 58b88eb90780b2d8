"""stage_ms: sampling and staging (``ops/ransac``, ``engine.run_round``
before its timed span), per view: the benchmark's clock around the call
less the round's ``RoundResult.total_ms``, mean over the window."""

import numpy as np


def read(run):
    ok = [r for r in run.requests if r.error is None]
    return float(np.mean([r.latency_ms - r.total_ms for r in ok])) if ok \
        else None
