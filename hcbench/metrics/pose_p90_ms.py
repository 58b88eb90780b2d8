"""pose_p90_ms: the 90th percentile (numpy's linear interpolation) of the
latency of every request of the window, from the view's handover to its
pose on the host, on the benchmark's host clock."""

import numpy as np


def read(run):
    return float(np.percentile([r.latency_ms for r in run.requests], 90))
