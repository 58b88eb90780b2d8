# Frozen copy of trifocal_pose_estimation_using_improved_gpuhc_torch/ops/schedule.py at commit e13ae2fbc8b3,
# the benchmark's plain reference: imports rewritten to hcbench.plain.  Never edit it to follow the program.
"""Static elimination schedules for the batched sparse complex solve.

Counterpart of the JAX package's ``ops/schedule.py`` (the symbolic part;
its host executor ``solve_numpy`` stays there as the tests' oracle).

The Jacobian Hx has a fixed sparsity pattern shared by every path and
every HC step.  This module analyses it once and emits an ordered list of
elimination steps, each naming

  * ``col``  -- the variable (column) eliminated at this step,
  * ``rows`` -- the candidate pivot rows: every row that can structurally
    hold a nonzero in ``col`` at this point (original pattern plus
    worst-case fill from all earlier steps),
  * ``cols`` -- the union of the candidate rows' column patterns.

Numerically each step picks, per path, the not-yet-used candidate row with
the largest |Re|+|Im| entry of ``col``: exact partial pivoting of the
column-permuted matrix, since rows outside ``rows`` hold exact zeros there.
Fill is tracked conservatively: after a step every candidate row's pattern
becomes the union minus the eliminated column, because any of them may
have been some path's pivot.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ElimStep:
    col: int                 # column (variable) eliminated
    rows: Tuple[int, ...]    # candidate pivot rows (static superset)
    cols: Tuple[int, ...]    # columns the update may touch (incl. rhs)


@dataclasses.dataclass(frozen=True)
class SolveSchedule:
    n: int                    # system size (30)
    width: int                # row storage width (n + 1 rhs, padded)
    rhs_col: int              # column index of the rhs inside a row
    steps: Tuple[ElimStep, ...]

    @property
    def update_volume(self) -> int:
        """Total candidate-row x touched-col volume (flop proxy)."""
        return sum(len(s.rows) * len(s.cols) for s in self.steps)


def build_schedule(pattern: np.ndarray, width: int | None = None) -> SolveSchedule:
    """Greedy static elimination schedule for a fixed sparsity pattern.

    pattern: (n, n) bool -- structural nonzeros of the matrix.  Columns are
    chosen greedily by (number of candidate rows, union pattern size,
    column id): the most decoupled variables go first, which delays the
    fill into the dense (rotation) tail.
    """
    n = pattern.shape[0]
    if width is None:
        width = n + 2  # n cols + rhs + pad to even
    rhs = n
    pats: List[set] = [set(np.nonzero(pattern[r])[0]) | {rhs} for r in range(n)]

    remaining = set(range(n))
    steps: List[ElimStep] = []
    while remaining:
        best = None
        for j in sorted(remaining):
            C = [r for r in range(n) if j in pats[r]]
            if not C:
                raise ValueError(f"structurally singular: no row holds col {j}")
            U = set()
            for r in C:
                U |= pats[r]
            cost = (len(C), len(U), j)
            if best is None or cost < best[0]:
                best = (cost, j, C, U)
        _, j, C, U = best
        steps.append(
            ElimStep(col=j, rows=tuple(sorted(C)), cols=tuple(sorted(U)))
        )
        new_pat = U - {j}
        for r in C:
            pats[r] = set(new_pat)
        remaining.remove(j)
    return SolveSchedule(n=n, width=width, rhs_col=rhs, steps=tuple(steps))


def find_interval_row_order(schedule: SolveSchedule) -> np.ndarray:
    """Row permutation making the candidate sets contiguous where possible.

    Ordered partition refinement: the candidate sets, smallest first, each
    pull their member blocks together.  Returns row_order (n,): new
    position -> original row.
    """
    n = schedule.n
    blocks: List[List[int]] = [list(range(n))]
    for st in sorted(schedule.steps, key=lambda s: len(s.rows)):
        c = set(st.rows)
        new_blocks: List[List[int]] = []
        members: List[List[int]] = []
        insert_at = None
        for b in blocks:
            inside = [r for r in b if r in c]
            outside = [r for r in b if r not in c]
            if inside:
                if insert_at is None:
                    insert_at = len(new_blocks)
                members.append(inside)
            if outside:
                new_blocks.append(outside)
        if insert_at is not None:
            for m in reversed(members):
                new_blocks.insert(insert_at, m)
        blocks = new_blocks
    order = [r for b in blocks for r in b]
    return np.array(order, np.int32)
