"""views_per_s: views recovered in the window (requests that returned a pose
within the ground truth's tolerances) over the window's seconds, on the
benchmark's host clock.  The cells drive one client in a closed loop, so
this is one robot's recovery rate, the reciprocal of its mean latency less
the failed requests, and not what a server of many streams gets from a
card."""


def read(run):
    return (len(run.requests) - run.failed) / run.window_s
