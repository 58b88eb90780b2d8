"""boundary_host_ms: the segment driver's host work per view (``ops/
segmented._Run.advance``): the durations of the program's
``segment.launch`` (the segment's launch queued) and ``segment.boundary``
(boundary scoring, compaction, the active count, the loop test queued)
spans, over the requests after the profiler stopped."""

from hcbench import program_spans


def read(run):
    return program_spans.ms_per_view(
        program_spans.untraced(run), ("segment.launch", "segment.boundary"))
