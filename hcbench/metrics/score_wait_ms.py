"""score_wait_ms: the round scoring's waits on the device per view
(``engine._score_round``): the program's ``score.readback`` (the per-path
flags copied to the host) and ``score.supports`` (the candidates' supports
and their copy) spans, over the requests after the profiler stopped; the
rest of ``score_ms`` is host work."""

from hcbench import program_spans


def read(run):
    return program_spans.ms_per_view(program_spans.untraced(run),
                                     ("score.readback", "score.supports"))
