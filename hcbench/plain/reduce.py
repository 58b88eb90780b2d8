# Frozen copy of trifocal_pose_estimation_using_improved_gpuhc_torch/ops/reduce.py at commit e13ae2fbc8b3,
# the benchmark's plain reference: imports rewritten to hcbench.plain.  Never edit it to follow the program.
"""Condensed elimination: group families + a compacted reduced system.

Counterpart of the JAX package's ``ops/reduce.py`` (the symbolic part;
its host executor ``solve_numpy`` stays there as the tests' oracle).

* **Group families** -- disjoint sets of <= 3 rows that own "local"
  columns (columns whose whole structural support lies inside the group).
  Every group of a family is eliminated in one stage, and each group's
  surviving rows move on to the next level; dead pivot rows never appear
  in a later stage.  The trifocal 30x30 pattern has 6 depth triples
  (3 rows / 1 local), 4 quads (3 rows / 2 locals) and, on the condensed
  pattern, 2 pairs (2 rows / 1 local): 16 of the 30 pivots.
* **Reduced system** -- the 14 surviving rows over the 14 remaining
  columns, solved by the ordinary static schedule (ops/schedule.py).

The pivots are those of the full schedule: each group elimination is the
schedule's restricted partial pivoting (|Re|+|Im|, first hit in ascending
row order, a zero pivot replaced by 1), and the compaction removes only
rows the schedule would never read again.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from hcbench.plain import schedule as sched


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """One elimination group inside a family.

    rows: indices into the level's input row list.  local_cols: columns
    eliminated by this group, in elimination order.
    """

    rows: Tuple[int, ...]
    local_cols: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Family:
    """Same-shape groups eliminated in one stage.

    level: 0 = groups of original rows; k > 0 = groups over the output rows
    of level k-1.  g: rows per group; l: local columns (pivots) per group.
    """

    level: int
    g: int
    l: int
    groups: Tuple[GroupSpec, ...]


@dataclasses.dataclass(frozen=True)
class ReductionPlan:
    n: int
    families: Tuple[Family, ...]
    num_levels: int
    # Row provenance (level, index into that level's rows) of each row of
    # the condensed system, and its columns (original ids) in the
    # elimination order of the final schedule.
    final_rows: Tuple[Tuple[int, int], ...]
    final_cols: Tuple[int, ...]
    schedule: sched.SolveSchedule             # over compressed col ids
    # Structural column sets of every level's input rows (level 0 =
    # original pattern rows).
    level_patterns: Tuple[Tuple[frozenset, ...], ...] = ()

    @property
    def num_group_pivots(self) -> int:
        return sum(f.l * len(f.groups) for f in self.families)


def _level_output_refs(
    n_in: int, groups: Sequence[GroupSpec]
) -> Tuple[List[Tuple[str, int, int]], List[int]]:
    """Output rows of one level: every group's g - l survivors in group
    order, then the rows no group holds, in input order."""
    grouped = set()
    outs: List[Tuple[str, int, int]] = []
    for gi, gr in enumerate(groups):
        grouped.update(gr.rows)
        for s in range(len(gr.rows) - len(gr.local_cols)):
            outs.append(("out", gi, s))
    passthrough = [r for r in range(n_in) if r not in grouped]
    return outs, passthrough


def _find_level_groups(
    patterns: List[frozenset], max_rows: int = 3, max_locals: int = 2
) -> List[GroupSpec]:
    """Disjoint row groups owning local columns, found in the greedy
    schedule's column preference order (support size, union pattern size,
    column id), so that they are the candidate sets the full schedule's
    early steps would use."""
    n_rows = len(patterns)
    support: dict = {}
    for r, p in enumerate(patterns):
        for c in p:
            support.setdefault(c, set()).add(r)

    def union_size(rows):
        u: set = set()
        for r in rows:
            u |= patterns[r]
        return len(u)

    order = sorted(
        support, key=lambda c: (len(support[c]), union_size(support[c]), c)
    )
    parent = list(range(n_rows))

    def find(r):
        while parent[r] != r:
            parent[r] = parent[parent[r]]
            r = parent[r]
        return r

    comp_size = [1] * n_rows
    for c in order:
        roots = {find(r) for r in support[c]}
        if sum(comp_size[r] for r in roots) > max_rows:
            continue
        it = iter(roots)
        base = next(it)
        for r in it:
            parent[r] = base
            comp_size[base] += comp_size[r]

    comps: dict = {}
    for r in range(n_rows):
        comps.setdefault(find(r), []).append(r)
    groups: List[GroupSpec] = []
    for rows in comps.values():
        if len(rows) < 2:
            continue
        rset = set(rows)
        locs = [c for c in support if support[c] <= rset]
        if not 1 <= len(locs) <= min(max_locals, len(rows) - 1):
            continue
        locs.sort(key=lambda c: (len(support[c]), union_size(support[c]), c))
        groups.append(GroupSpec(tuple(sorted(rows)), tuple(locs)))
    groups.sort(key=lambda g: g.rows)
    return groups


def build_reduction(pattern: np.ndarray) -> Optional[ReductionPlan]:
    """Symbolic condensation of a fixed sparsity pattern.

    Returns None when no group family exists or the condensed system is
    not square (the plain schedule is then the right tool).
    """
    n = pattern.shape[0]
    patterns = [
        frozenset(np.nonzero(pattern[r])[0].tolist()) for r in range(n)
    ]
    families: List[Family] = []
    level_patterns: List[Tuple[frozenset, ...]] = [tuple(patterns)]
    level = 0
    while True:
        groups = _find_level_groups(patterns)
        if not groups:
            break
        by_shape: dict = {}
        for gr in groups:
            by_shape.setdefault((len(gr.rows), len(gr.local_cols)), []).append(
                gr
            )
        for (g, l), grs in sorted(by_shape.items()):
            families.append(Family(level, g, l, tuple(grs)))
        outs, passthrough = _level_output_refs(len(patterns), groups)
        new_patterns: List[frozenset] = []
        for _kind, gi, _slot in outs:
            gr = groups[gi]
            u: set = set()
            for r in gr.rows:
                u |= patterns[r]
            new_patterns.append(frozenset(u - set(gr.local_cols)))
        for r in passthrough:
            new_patterns.append(patterns[r])
        patterns = new_patterns
        level_patterns.append(tuple(patterns))
        level += 1
    if level == 0:
        return None
    remaining = sorted({c for p in patterns for c in p})
    if len(remaining) != len(patterns):
        return None
    col_of = {c: i for i, c in enumerate(remaining)}
    m = len(remaining)
    fp = np.zeros((m, m), bool)
    for r, p in enumerate(patterns):
        for c in p:
            fp[r, col_of[c]] = True
    s = sched.build_schedule(fp)
    return ReductionPlan(
        n=n,
        families=tuple(families),
        num_levels=level,
        final_rows=tuple((level, i) for i in range(len(patterns))),
        final_cols=tuple(remaining[st.col] for st in s.steps),
        schedule=s,
        level_patterns=tuple(level_patterns),
    )
