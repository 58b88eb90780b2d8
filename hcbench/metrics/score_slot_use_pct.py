"""score_slot_use_pct: the share of the TrunRANSAC boundary scoring's
computed slots (``segmented._Run._score_new``: up to 128 a boundary) that
held a newly converged path: 100 x the program's ``scored_paths`` over its
``score_slots`` counters, over the window's requests that the program's
log of its last rounds reaches."""

from hcbench import program_spans


def read(run):
    counts = [k[1] for k in program_spans.rounds(run) if k is not None]
    slots = sum(c.get("score_slots", 0) for c in counts)
    if not slots:
        return None
    return 100.0 * sum(c.get("scored_paths", 0) for c in counts) / slots
