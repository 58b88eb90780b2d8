"""hc_track_ms: device time of the tracker kernel (kernels named
``hc_track*``) per view, over the traced requests (the profiler's trace of
the window's first seconds); in a cell of several cards the mean card's,
the cards' sum over their number."""


def hc_track_s(device_s: dict) -> float:
    return sum(s for name, s in device_s.items() if "hc_track" in name)


def read(run):
    if run.trace is None or not run.trace.requests:
        return None
    total = sum(hc_track_s(d) for d in run.trace.device_s.values())
    return total / run.chips * 1e3 / run.trace.requests
