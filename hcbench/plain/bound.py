# Frozen copy of trifocal_pose_estimation_using_improved_gpuhc_torch/ops/bound.py at commit e13ae2fbc8b3,
# the benchmark's plain reference: imports rewritten to hcbench.plain; trimmed to what tracker_bound needs for the
# benchmark's configurations (RK4, the "efg" basis, the FP32 evaluation, no replays): replay_flops, split_flops,
# family_steps, phase_flops, forward_flops' steps argument and the per-order and per-basis tables left out.
# Never edit it to follow the program.
"""The least time the card could take for the tracker's work: operation
counts of its pieces, and the bound of a tracker call from them.

An evaluation is counted as the function needs it: each distinct monomial
and each combo once, then the scale and the add of each term, whatever the
kernel recomputes.  A solve is counted over the symbolic pattern with fill
of its program (``fill_steps``).  The bound of a call is the larger of
its FP32 operations over the card's FP32 rate outside the tensor cores and
its bytes, each read or written once, over the memory rate.
The program's ``tests/test_torch_bound.py`` pins the original's counts.
"""

from __future__ import annotations

import numpy as np

# One H100 SXM at its 700 W limit: FP32 outside the tensor cores, HBM3.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def fill_steps(c):
    """The symbolic pattern with fill of the constants' solve program, per
    pivot step in program order: (step, column, rows, pattern), where rows
    are the candidate rows not used by an earlier step (the pivot is one
    of them) and pattern is the set of columns, rhs (c.n) included, that
    the pivot row may hold after the eliminated column.

    The rows start with the Hx pattern plus the rhs.  As in the schedule
    analysis (``ops/schedule.py``), fill is taken over the union: after a
    step every unused candidate row holds the union of their patterns
    minus the column, since any of them may be some path's pivot.  An
    earlier-eliminated column is in no pattern: a row that was not a
    candidate has a structural zero there (checked), and a candidate was
    reduced to zero.  Later levels' rows are found through the row maps
    with the first unused candidate as the pivot; after a group's first
    step its rows share one pattern, so which one pivots does not change
    the patterns."""
    n = c.n
    pats = [{n} for _ in range(n)]
    for r, col in zip(c.nz_row, c.nz_col):
        pats[int(r)].add(int(col))
    used, rmap, level, out = set(), [int(r) for r in c.map0], 0, []
    for st in c.stages:
        while level < st.level:
            rmap = [[rmap[s] for s in src if s >= 0 and rmap[s] not in used][k]
                    for *src, k in c.maps[level].tolist()]
            level += 1
        picks = []
        for s, col, cand in zip(st.steps, st.cols, st.cands):
            rows = [rmap[i] for i in cand if rmap[i] not in used]
            if any(col in pats[r] for r in set(range(n)) - used - set(rows)):
                raise ValueError(f"step {s}: a non-candidate row holds "
                                 f"column {col}")
            pattern = set().union(*(pats[r] for r in rows)) - {col}
            picks.append((s, col, rows, pattern))
        for _, _, rows, pattern in picks:
            used.add(rows[0])
            for r in rows[1:]:
                pats[r] = set(pattern)
        out.extend(picks)
    return out


def monomial_flops(c, rhs_only=False):
    """FP32 operations of an evaluation's monomials (or, rhs_only, of a
    replay's rhs): each distinct one once, 6 for a quadratic monomial (one
    complex product), 12 for a cubic one (two)."""
    flops = 12 * len(np.unique(c.ht_m))
    if not rhs_only:
        flops += 6 * len(np.unique(c.hx_m))
    return flops


def assembly_flops(c, rhs_only=False):
    """FP32 operations of one evaluation (or, rhs_only, of a replay's rhs),
    counted as the function needs them: the monomials
    (``monomial_flops``), each combo P[q] x^m once (6), and per term the
    integer scale and the complex add (4)."""
    nz_terms, rhs_terms = c.term_lists()
    parts = [(rhs_terms, c.ht_C)]
    if not rhs_only:
        parts.append((nz_terms, c.hx_C))
    return monomial_flops(c, rhs_only) + sum(
        6 * int((C != 0).any(1).sum()) + 4 * sum(map(len, terms))
        for terms, C in parts)


def forward_flops(c):
    """FP32 operations of the forward elimination over every pivot step
    (``fill_steps``), per step: the pivot metric of each unused candidate
    (one add), the reciprocal (3 + 2), and per other unused candidate the
    multiplier (6) and the update of the pivot row's pattern (8 per
    entry)."""
    return sum(len(rows) + 5 + (len(rows) - 1) * (6 + 8 * len(pattern))
               for _, _, rows, pattern in fill_steps(c))


def backsub_flops(c):
    """FP32 operations of one back-substitution: per step a complex dot
    over the pivot row's pattern (8 per column), the rhs (2) and the
    scaled result (11)."""
    return sum(8 * (len(pattern) - 1) + 2 + 11
               for *_, pattern in fill_steps(c))


def solve_flops(c):
    """FP32 operations of one assemble + solve of the constants' program:
    ``assembly_flops``, ``forward_flops`` over the pattern with fill
    (``fill_steps``) and ``backsub_flops``."""
    return assembly_flops(c) + forward_flops(c) + backsub_flops(c)


# Per path-step outside the solves (RK4, two-point basis): the RK stages'
# fills of P and dP/dt (one per distinct t, 3, at 20 a pair) and the
# corrector's fill of P (10 a pair), and the stage points and the RK
# combination (740).
PAIR_FLOPS = 3 * 20 + 10
STEP_FLOPS = 740


def tracker_flops(c, work):
    """FP32 operations of the tracker work ``work`` (the path-steps,
    corrector iterations and full solves, as ``fused.track_plain`` counts
    them)."""
    # A corrector iteration beyond its solve: the update and two norms.
    return (work["solves"] * solve_flops(c)
            + work["steps"] * (PAIR_FLOPS * c.q + STEP_FLOPS)
            + work["newton"] * 240)


def tracker_bound(c, work, n_paths):
    """(bound_ms, bound_by) of one tracker call over n_paths: the larger of
    the FP32 operations its paths really did (``tracker_flops``; the
    kernel matches track_plain bit for bit) over 67 TFLOP/s and its bytes
    (state, flags and coefficients read once, state and flags written
    once, the plan read once) over 3.35 TB/s."""
    flops = tracker_flops(c, work)
    nbytes = n_paths * (4 * 30 * 8 + 2 * 8 * 4 + 3 * c.q * 8) \
        + 4 * c.kernel_plan().size
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
