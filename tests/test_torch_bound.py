"""The operation count behind chip_smoke.py's bound of the tracker kernel.

``chip_smoke.fill_steps`` gives, per pivot step of a solve program, the
columns the pivot row may hold (the symbolic pattern with fill), and
``solve_flops`` counts the solve over those columns only.  The count is
right only if the pattern covers every entry the solve really meets: on
seeded random systems with the Hx pattern, every nonzero that the plain
solve leaves in a step's pivot row, in a column still to be eliminated or
the rhs, lies in that step's pattern, for both solve programs.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import config

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")
_SYSTEMS = 256


@pytest.fixture(scope="module")
def problem():
    return trifocal.TrifocalProblem.load(config.EngineConfig(data_root=DATA))


@pytest.mark.parametrize("solver", ["reduced", "schedule"])
def test_fill_pattern_covers_the_solve(problem, solver):
    c = fused.FusedConstants.build(problem, solver=solver)
    tb = fused._Tables(c, "cpu")
    steps = chip_smoke.fill_steps(c)
    assert sorted(s for s, *_ in steps) == list(range(c.n))
    rng = np.random.default_rng(0)
    mr = torch.zeros((_SYSTEMS, c.n, fused.WIDTH))
    mi = torch.zeros_like(mr)
    rows, cols = torch.as_tensor(c.nz_row).long(), torch.as_tensor(c.nz_col).long()
    for m in (mr, mi):
        m[:, rows, cols] = torch.as_tensor(
            rng.standard_normal((_SYSTEMS, len(rows))), dtype=torch.float32)
        m[:, :, c.n] = torch.as_tensor(
            rng.standard_normal((_SYSTEMS, c.n)), dtype=torch.float32)
    _, piv = fused.solve_plain(tb, (mr, mi), return_pivots=True)
    a = torch.arange(_SYSTEMS)
    pivots_seen = 0
    for s, col, cand_rows, pattern in steps:
        assert col == tb.step_cols[s] and cand_rows
        later = set(tb.step_cols[s + 1:]) | {c.n}
        assert pattern <= later, (s, pattern - later)
        outside = sorted(later - pattern)
        held = (mr[a, piv[:, s]][:, outside] != 0) | \
            (mi[a, piv[:, s]][:, outside] != 0)
        assert not bool(held.any()), (s, outside)
        pivots_seen += len(set(piv[:, s].tolist()))
    # The random systems pivot on more than one row at most steps, so the
    # pattern held for many pivot sequences, not only the simulated one.
    assert pivots_seen > 2 * c.n


@pytest.mark.parametrize("solver,flops", [("reduced", 34138),
                                          ("schedule", 33918)])
def test_solve_flops_of_the_committed_problem(problem, solver, flops):
    """The per-solve counts that PERF.md's bounds rest on."""
    c = fused.FusedConstants.build(problem, solver=solver)
    assert chip_smoke.solve_flops(c) == flops
