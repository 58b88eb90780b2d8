"""shard_lag_ms: how long after the first shard's segment the last shard's
segment is queued, per view (``parallel/mesh._ShardedRun.advance``): for
each ``mesh.advance`` span, the end of its last ``segment.launch`` child
less the end of its first, summed over the requests after the profiler
stopped.  None where the program records no ``mesh.advance`` span (a
round on one card, or a program whose mesh records no spans)."""

from hcbench import program_spans


def read(run):
    kept = program_spans.untraced(run)
    lag, seen = 0, False
    for spans, _ in kept:
        first, last = {}, {}
        for name, _, end, parent in spans:
            seen |= name == "mesh.advance"
            if name == "segment.launch" and parent >= 0 and (
                    spans[parent][0] == "mesh.advance"):
                first.setdefault(parent, end)
                last[parent] = end
        lag += sum(last[p] - first[p] for p in last)
    return lag * 1e-6 / len(kept) if seen else None
