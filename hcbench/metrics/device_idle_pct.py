"""device_idle_pct: the share of the traced window in which no operation
ran on the device: 100 x (1 - union of the device intervals / window)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
