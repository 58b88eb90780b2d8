"""boundary_wait_ms: the segment driver's wait for each boundary's loop test
per view (``ops/segmented._Run.poll``): the durations of the program's
``segment.wait`` spans, over the requests after the profiler stopped."""

from hcbench import program_spans


def read(run):
    return program_spans.ms_per_view(program_spans.untraced(run),
                                     ("segment.wait",))
