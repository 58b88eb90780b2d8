"""mesh_move_ms: the hypothesis mesh's scatter and gather per view
(``parallel/mesh._ShardedRun``): the durations of the program's
``mesh.scatter`` (each shard handed its block and its run begun) and
``mesh.gather`` (the paths queued to the first card, the outcome read)
spans, over the requests after the profiler stopped.  None where the
program records no ``mesh.*`` span (a round on one card, or a program
whose mesh records no spans)."""

from hcbench import program_spans

NAMES = ("mesh.scatter", "mesh.gather")


def read(run):
    kept = program_spans.untraced(run)
    if not any(name in NAMES for spans, _ in kept for name, *_ in spans):
        return None
    return program_spans.ms_per_view(kept, NAMES)
