"""boundary_gap_ms: the segment driver's host time per view (``ops/
segmented``): the rounds' ``track_ms`` less the device time of their
``hc_track*`` kernels (profiler), over the traced requests, per view."""


def read(run):
    if run.trace is None or not run.trace.requests:
        return None
    n = run.trace.requests
    kernel = sum(s for d in run.trace.device_s.values()
                 for name, s in d.items() if "hc_track" in name)
    track = sum(r.track_ms for r in run.requests[:n]) * 1e-3
    return (track - kernel) * 1e3 / n
