"""hc_track_launches: tracker kernel launches per view (the program's
counter ``ops/_kernels.hc_track.launches`` over the window): one per
segment the segment driver runs."""


def read(run):
    return run.launches / len(run.requests)
