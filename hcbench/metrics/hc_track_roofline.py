"""hc_track_roofline: the tracker kernel's share of its roofline on the
request the reference recomputed: the frozen ``tracker_bound`` (the larger
of FP32 operations over 67 TFLOP/s and bytes over 3.35 TB/s, one card's
peaks) of the work the frozen plain tracker counts on that round's inputs,
over the device time of that round's ``hc_track*`` kernels, summed over
the cards.  In a cell of k cards that is the round's share of the cards'
combined roofline (k times the peaks) over the kernels' time on the mean
card."""


def read(run):
    if run.trace is None or run.bound_ms is None:
        return None
    device = run.trace.device_s.get(run.checked, {})
    ms = sum(s for name, s in device.items() if "hc_track" in name) * 1e3
    return 100.0 * run.bound_ms / ms if ms > 0 else None
