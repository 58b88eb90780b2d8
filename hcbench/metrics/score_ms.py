"""score_ms: the round's scoring and host tail (``engine._score_round``,
``utils/evaluation``), per view: ``total_ms - track_ms``, mean over the
window."""

import numpy as np


def read(run):
    ok = [r for r in run.requests if r.error is None]
    return float(np.mean([r.total_ms - r.track_ms for r in ok])) if ok \
        else None
