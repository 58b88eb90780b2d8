"""The least time the card could take for the tracker's work: operation
counts of its pieces, and the bound of a tracker call from them.

An evaluation is counted as the function needs it: each distinct monomial
and each combo once, then the scale and the add of each term, whatever the
kernel recomputes.  A solve is counted over the symbolic pattern with fill
of its program (``fill_steps``).  The bound of a call is the larger of
its FP32 operations over the card's FP32 rate outside the tensor cores and
its bytes, each read or written once, over the memory rate.
``chip_smoke.py``, ``ops/phases.py`` and ``tools/microbench_torch.py``
read the counts here; ``tests/test_torch_bound.py`` pins them.
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


def forward_flops(c, steps=None):
    """FP32 operations of the forward elimination over ``steps`` (default
    every pivot step; ``fill_steps`` indices in program order), per step:
    the pivot metric of each unused candidate (one add), the reciprocal
    (3 + 2), and per other unused candidate the multiplier (6) and the
    update of the pivot row's pattern (8 per entry)."""
    picks = fill_steps(c)
    picks = picks if steps is None else [picks[i] for i in steps]
    return sum(len(rows) + 5 + (len(rows) - 1) * (6 + 8 * len(pattern))
               for _, _, rows, pattern in picks)


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


def replay_flops(c):
    """FP32 operations of one replay of a kept elimination on a new rhs:
    the rhs-only assembly (``assembly_flops``), per step the update of
    each other unused candidate's rhs (8), and the back-substitution of
    ``solve_flops``."""
    flops = assembly_flops(c, rhs_only=True)
    for _, _, rows, pattern in fill_steps(c):
        flops += 8 * (len(rows) - 1) + 8 * (len(pattern) - 1) + 2 + 11
    return flops


def split_flops(c, rhs_only=False):
    """FP32 operations that eval_precision "split3_rk2" adds to one RK-stage
    assembly (or, rhs_only, to a replay's rhs), counted as the function
    needs them (the JAX package's _eval_core with _sdot2): the point's
    split, a subtraction and an addition per real (4 per entry); the same
    once per distinct monomial the evaluation uses (4); the low part of
    each combo's value v = P x^m, once per combo (2); per term the second
    sum (4); per entry the add of the two sums (2).  The kernel splits
    each term's monomial and value again, redundant work it is not
    credited for.  The bf16 conversions are conversions, not counted."""
    nz_terms, rhs_terms = c.term_lists()
    monos, combos = len(np.unique(c.ht_m)), len(c.ht_q)
    terms, entries = sum(map(len, rhs_terms)), c.n
    if not rhs_only:
        monos += len(np.unique(c.hx_m))
        combos += len(c.hx_q)
        terms += sum(map(len, nz_terms))
        entries += len(nz_terms)
    return 4 * c.n + 4 * monos + 2 * combos + 4 * terms + 2 * entries


# Per path-step outside the solves: the RK stages' fills of P and dP/dt
# (one per distinct t: 3 for rk4 and rk3, 2 for rk2) and the corrector's
# fill of P, per pair (two-point basis 20 and 10, "abc" 14 and 8), and the
# stage points and the RK combination, by predictor order.
RK_FILLS = {4: 3, 3: 3, 2: 2}
FILL_FLOPS = {"efg": (20, 10), "abc": (14, 8)}
STEP_FLOPS = {4: 740, 3: 740, 2: 260}


def tracker_flops(c, work, order=4, basis="efg"):
    """FP32 operations of the tracker work ``work`` (the path-steps,
    corrector iterations, full solves and replays, and those of them that
    were split RK-stage evaluations, as ``fused.track_plain`` counts
    them)."""
    rk_fill, corr_fill = FILL_FLOPS[basis]
    per_pair = RK_FILLS[order] * rk_fill + corr_fill
    # A corrector iteration beyond its solve: the update and two norms.
    return (work["solves"] * solve_flops(c)
            + work.get("replays", 0) * replay_flops(c)
            + work.get("split_solves", 0) * split_flops(c)
            + work.get("split_replays", 0) * split_flops(c, rhs_only=True)
            + work["steps"] * (per_pair * c.q + STEP_FLOPS[order])
            + work["newton"] * 240)


def tracker_bound(c, work, n_paths, order=4, basis="efg"):
    """(bound_ms, bound_by) of one tracker call over n_paths: the larger of
    the FP32 operations its paths really did (``tracker_flops``; the
    kernel matches track_plain bit for bit) over 67 TFLOP/s and its bytes
    (state, flags and coefficients read once, state and flags written
    once, the plan read once) over 3.35 TB/s."""
    flops = tracker_flops(c, work, order, basis)
    nbytes = n_paths * (4 * 30 * 8 + 2 * 8 * 4 + 3 * c.q * 8) \
        + 4 * c.kernel_plan().size
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def family_steps(c):
    """How many of the program's pivot steps (in program order) are the
    condensed program's family stages; 0 for the schedule program."""
    return sum(len(st.steps) for st in c.stages if st.level < len(c.maps))


def phase_flops(c, phase, basis="efg", split2=False):
    """FP32 operations of one iteration of a port phase (``ops/phases.py``)
    on one path, counted as above: "fill" the RK fill of P and dP/dt;
    "monomials" and "walk"/"walk_bf16" the two parts of an evaluation
    (the walk's bf16 roundings are conversions); "eval" and "evasm" a fill
    and an evaluation, "evrhs" a fill and the rhs alone; "elim" and
    "evsolve" add the forward elimination, and the whole solve;
    "elimfam"/"elimtail" the forward elimination of the family / the
    reduced steps; "back" a back-substitution; "replay" the corrector's
    fill and a replay.  With ``split2`` (eval_precision "split3_rk2") the
    phases that evaluate at an RK stage add ``split_flops``.  "step"
    depends on the data: ``tracker_flops`` of the work counted."""
    rk_fill = FILL_FLOPS[basis][0] * c.q
    split = split_flops(c) if split2 else 0
    n_fam = family_steps(c)
    counts = {
        "fill": lambda: rk_fill,
        "monomials": lambda: monomial_flops(c),
        "walk": lambda: assembly_flops(c) - monomial_flops(c),
        "walk_bf16": lambda: assembly_flops(c) - monomial_flops(c),
        "eval": lambda: rk_fill + assembly_flops(c) + split,
        "evasm": lambda: rk_fill + assembly_flops(c) + split,
        "evrhs": lambda: rk_fill + assembly_flops(c, rhs_only=True) + (
            split_flops(c, rhs_only=True) if split2 else 0),
        "elim": lambda: rk_fill + assembly_flops(c) + forward_flops(c)
        + split,
        "elimfam": lambda: forward_flops(c, range(n_fam)),
        "elimtail": lambda: forward_flops(c, range(n_fam, c.n)),
        "back": lambda: backsub_flops(c),
        "evsolve": lambda: rk_fill + solve_flops(c) + split,
        "replay": lambda: FILL_FLOPS[basis][1] * c.q + replay_flops(c),
    }
    if phase not in counts:
        raise ValueError(f"no fixed count for phase {phase!r}")
    if phase in ("elimfam", "elimtail") and n_fam == 0:
        raise ValueError(f"{phase} takes the condensed program ('reduced')")
    return counts[phase]()
