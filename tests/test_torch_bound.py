"""The operation count behind chip_smoke.py's bound of the tracker kernel.

An evaluation is counted as the function needs it (``assembly_flops``,
pinned here): each distinct monomial and each combo once, then the scale
and the add of each term, whatever the kernel recomputes.
Under eval_precision "split3_rk2" the RK stages' evaluations add the
split's FP32 operations (``split_flops``, pinned here), counted once per
point entry, distinct monomial and combo as the function needs them, not
per term as the kernel redoes them; its bf16 conversions are conversions
and are not counted in the bound.

``chip_smoke.fill_steps`` gives, per pivot step of a solve program, the
columns the pivot row may hold (the symbolic pattern with fill), and
``solve_flops`` counts the solve over those columns only.  The count is
right only if the pattern covers every entry the solve really meets: on
seeded random systems with the Hx pattern, every nonzero that the plain
solve leaves in a step's pivot row, in a column still to be eliminated or
the rhs, lies in that step's pattern, for both solve programs.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import chip_smoke
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused, ransac
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
    config,
    data_io,
)

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


@pytest.mark.parametrize("solver", ["reduced", "schedule"])
def test_assembly_flops_of_the_committed_problem(problem, solver):
    """An evaluation's count, as the function needs it: 6 per quadratic
    monomial (107), 12 per cubic one (175), 6 per combo (450 Hx, 461 rhs)
    and 4 per term (926 Hx, 528 rhs); a replay's rhs, its cubic part."""
    c = fused.FusedConstants.build(problem, solver=solver)
    assert chip_smoke.assembly_flops(c) == \
        6 * 107 + 12 * 175 + 6 * 911 + 4 * 1454 == 14024
    assert chip_smoke.assembly_flops(c, rhs_only=True) == \
        12 * 175 + 6 * 461 + 4 * 528 == 6978


@pytest.mark.parametrize("solver,flops", [("reduced", 21730),
                                          ("schedule", 21510)])
def test_solve_flops_of_the_committed_problem(problem, solver, flops):
    """The per-solve counts that PERF.md's bounds rest on: the assembly
    once per monomial and combo, then the solve over its pattern."""
    c = fused.FusedConstants.build(problem, solver=solver)
    assert chip_smoke.solve_flops(c) == flops
    assert flops - chip_smoke.assembly_flops(c) == \
        {"reduced": 7706, "schedule": 7486}[solver]


@pytest.mark.parametrize("solver,flops", [("reduced", 9432),
                                          ("schedule", 9400)])
def test_replay_flops_of_the_committed_problem(problem, solver, flops):
    """A replay's count: the rhs-only assembly, 8 per other unused
    candidate per step on the rhs column, and the solve's
    back-substitution."""
    c = fused.FusedConstants.build(problem, solver=solver)
    backsub = sum(8 * (len(p) - 1) + 13 for *_, p in chip_smoke.fill_steps(c))
    updates = sum(8 * (len(r) - 1) for _, _, r, _ in chip_smoke.fill_steps(c))
    assert chip_smoke.replay_flops(c) == \
        chip_smoke.assembly_flops(c, rhs_only=True) + updates + backsub == flops


@pytest.mark.parametrize("solver", ["reduced", "schedule"])
def test_split_flops_of_the_committed_problem(problem, solver):
    """The split's added count, as the function needs it: 4 per point
    entry, 4 per distinct monomial (107 quadratic, 175 cubic), 2 per combo
    (450 Hx, 461 rhs), 4 per term (926 Hx, 528 rhs) and 2 per entry
    (170 + 30) of an RK-stage assembly, or of a replay's rhs alone."""
    c = fused.FusedConstants.build(problem, solver=solver)
    assert chip_smoke.split_flops(c) == \
        120 + 4 * 282 + 2 * 911 + 4 * 1454 + 2 * 200 == 9286
    assert chip_smoke.split_flops(c, rhs_only=True) == \
        120 + 4 * 175 + 2 * 461 + 4 * 528 + 2 * 30 == 3914


# (knobs, RK stages per step)
_WORK = {
    "rk4": ({}, 4), "rk3": (dict(predictor="rk3"), 3),
    "rk2": (dict(predictor="rk2"), 2),
    "cjr1": (dict(corrector_jacobian_reuse=1), 4),
    "cjr2": (dict(corrector_jacobian_reuse=2), 4),
    "cph": (dict(predictor_handoff=True, tile=1), 4),
    "rkj": (dict(rk_jacobian_reuse=True), 4),
    "split2": (dict(eval_precision="split3_rk2"), 4),
    "abc": (dict(pair_coef_basis="abc"), 4),
    "rkj-split2": (dict(rk_jacobian_reuse=True,
                        eval_precision="split3_rk2"), 4),
}


@pytest.mark.parametrize("variant", list(_WORK))
def test_track_plain_counts_solves_and_replays(problem, variant):
    """The work the bound is computed from: every RK stage and corrector
    iteration is one full solve or one replay; RKJ replays stages 2-4,
    CPH at most stage 1, CJR only corrector iterations; under
    "split3_rk2" every RK stage's, and no corrector iteration's, is
    split."""
    knobs, stages = _WORK[variant]
    hc = dataclasses.replace(config.HCConfig(), **knobs)
    c = fused.FusedConstants.build(problem, solver=fused.solver_of(hc))
    x = torch.as_tensor(problem.start_sols[:16][:, c.perm])
    view = data_io.load_ransac_view(config.ransac_data_dir(
        config.EngineConfig(data_root=DATA)), 0)
    s = ransac.sample_edgel_triplets(0, view.edge_locations.shape[0], 1)
    tgt = torch.as_tensor(ransac.build_target_params(
        view.edge_locations, view.edge_tangents, s)).repeat(16, 1)
    work = {}
    fused.track_plain(c, hc, x, x, fused.init_flags(hc, 16),
                      fused.build_pair_coefs(problem, tgt,
                                             hc.pair_coef_basis), niter=6,
                      work=work)
    steps, newton = work["steps"], work["newton"]
    replays = work.get("replays", 0)
    assert steps == 16 * 6
    assert work["solves"] + replays == stages * steps + newton
    split = work.get("split_solves", 0) + work.get("split_replays", 0)
    assert split == (stages * steps if "split2" in variant else 0)
    if variant == "rkj-split2":
        assert work.get("split_replays", 0) == replays == 3 * steps
    elif variant == "rkj":
        assert replays == 3 * steps
    elif variant == "cph":
        assert 0 < replays < steps
    elif variant == "cjr1":
        # Every iteration after a path's first replays.
        assert replays == newton - steps > 0
    elif variant == "cjr2":
        assert replays < newton - steps
    else:
        assert replays == 0
