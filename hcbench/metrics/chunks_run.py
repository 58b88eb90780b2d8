"""chunks_run: the TrunRANSAC abort's chunks tracked per view
(``RoundResult.chunks_run``), mean over the window."""

import numpy as np


def read(run):
    ok = [r for r in run.requests if r.error is None]
    return float(np.mean([r.chunks_run for r in ok])) if ok else None
