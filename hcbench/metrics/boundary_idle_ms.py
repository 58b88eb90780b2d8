"""boundary_idle_ms: the device's idle time inside the segment driver's
spans per view (``ops/segmented._Run``: ``segment.launch``,
``segment.boundary`` and ``segment.wait``), over the traced requests: the
trace's merged device intervals laid over each request's spans, each idle
instant given to the innermost span that covers it
(``program_spans.self_idle``); in a cell of several cards the mean
card's."""

from hcbench import program_spans


def read(run):
    if run.trace is None or not run.trace.busy:
        return None
    kept = [k for r, k in zip(run.requests[:run.trace.requests],
                              program_spans.rounds(run))
            if k is not None and r.error is None]
    if not kept:
        return None
    idle = 0.0
    for busy in map(program_spans.Busy, run.trace.busy):
        for spans, _ in kept:
            idle += sum(own for (name, *_), own in zip(
                spans, program_spans.self_idle(spans, busy))
                if name.startswith("segment."))
    return idle * 1e3 / len(run.trace.busy) / len(kept)
