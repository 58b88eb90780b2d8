"""The plain solve (ops/fused.solve_plain) against the JAX package's host
oracles: the condensed program against ops/reduce.solve_numpy, the
static-schedule program against ops/schedule.solve_numpy.

Systems are random complex matrices on the committed problem's Jacobian
sparsity pattern, made from a seed with numpy.  Pivot choices must be the
oracle's: each step's pivot magnitude |Re|+|Im| equals the oracle's for
the same column (a different pivot row would differ by O(1)), within
1e-5 relative for float32 rounding of the updates before it.  x agrees
within rtol 1e-4: the oracle runs the same eliminations in complex64, and
only summation order differs.
"""

import os
import types

import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import reduce as redu
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import (
    schedule as jsched,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
    EngineConfig,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")
_B = 16


@pytest.fixture(scope="module")
def consts():
    problem = trifocal.TrifocalProblem.load(EngineConfig(data_root=DATA))
    return problem, fused.FusedConstants.build(problem)


@pytest.fixture(scope="module")
def systems(consts):
    problem, _ = consts
    f = problem.factored
    pattern = f.hx_scatter.reshape(30, 30) != f.hx_C.shape[1]
    rng = np.random.default_rng(11)
    a = (rng.standard_normal((_B, 30, 30))
         + 1j * rng.standard_normal((_B, 30, 30))) * pattern
    b = rng.standard_normal((_B, 30)) + 1j * rng.standard_normal((_B, 30))
    return a.astype(np.complex64), b.astype(np.complex64)


def _recording(solve):
    """Run solve() with numpy's argmax recording each pivot search's
    winning metric; return (x, metrics in search order)."""
    metrics = []

    def argmax(m, *args, **kw):
        i = np.argmax(m, *args, **kw)
        metrics.append(float(m[i]))
        return i

    proxy = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                     if not k.startswith("__")})
    proxy.argmax = argmax
    saved = redu.np, jsched.np
    redu.np = jsched.np = proxy
    try:
        return solve(), metrics
    finally:
        redu.np, jsched.np = saved


def _oracle_pivots(plan, a, b):
    """Run reduce.solve_numpy, recording each pivot search's winning
    metric; return (x, {column: pivot metric})."""
    x, metrics = _recording(lambda: redu.solve_numpy(plan, a, b))
    # Oracle order: per level, groups by rows and their local columns;
    # then the reduced schedule's steps.
    cols = []
    for level in range(plan.num_levels):
        groups = sorted((g for f in plan.families if f.level == level
                         for g in f.groups), key=lambda g: g.rows)
        for g in groups:
            cols.extend(g.local_cols)
    cols.extend(plan.final_cols)
    assert len(cols) == len(metrics) == plan.n
    return x, dict(zip(cols, metrics))


def _plain(consts, a, b):
    _, c = consts
    m = np.zeros((len(a), 30, fused.WIDTH), np.complex64)
    m[:, :, :30] = a[:, c.row_order][:, :, c.perm]
    m[:, :, 30] = b[:, c.row_order]
    tb = fused._Tables(c, "cpu")
    mr = torch.as_tensor(m.real.copy())
    mi = torch.as_tensor(m.imag.copy())
    x, piv = fused.solve_plain(tb, (mr, mi), return_pivots=True)
    x = torch.complex(*x).numpy()[:, np.argsort(c.perm)]
    pm = {}
    ar = torch.arange(len(a))
    for st in c.stages:
        for s, col in zip(st.steps, st.cols):
            vr = mr[ar, piv[:, s], col].numpy()
            vi = mi[ar, piv[:, s], col].numpy()
            pm[int(c.perm[col])] = np.abs(vr) + np.abs(vi)
    return x, pm


def test_solve_matches_reduce_oracle(consts, systems):
    problem, c = consts
    a, b = systems
    x, pm = _plain(consts, a, b)
    for i in range(len(a)):
        xo, om = _oracle_pivots(c.plan, a[i].copy(), b[i].copy())
        for col, metric in om.items():
            np.testing.assert_allclose(pm[col][i], metric, rtol=1e-5,
                                       err_msg=f"system {i} column {col}")
        np.testing.assert_allclose(x[i], xo, rtol=1e-4,
                                   atol=1e-4 * np.abs(xo).max())


def test_solve_matches_dense_solution(consts, systems):
    """The restricted pivoting still solves the system: against a dense
    complex128 solve, within 1e-4 relative (float32 elimination)."""
    a, b = systems
    x, _ = _plain(consts, a, b)
    for i in range(len(a)):
        xd = np.linalg.solve(a[i].astype(complex), b[i].astype(complex))
        assert np.abs(x[i] - xd).max() < 1e-4 * np.abs(xd).max()


def test_zero_pivot_guard(consts):
    """A structurally present but numerically zero column keeps the zero
    |pivot|^2 -> 1 guard of the kernel: no NaN, no division by zero."""
    problem, c = consts
    f = problem.factored
    pattern = f.hx_scatter.reshape(30, 30) != f.hx_C.shape[1]
    rng = np.random.default_rng(5)
    a = ((rng.standard_normal((30, 30)) + 1j * rng.standard_normal((30, 30)))
         * pattern).astype(np.complex64)
    first = int(c.perm[c.stages[0].cols[0]])
    a[:, first] = 0.0
    x, _ = _plain(consts, a[None], np.ones((1, 30), np.complex64))
    assert np.isfinite(x).all()
    assert x[0, first] == 0.0


@pytest.fixture(scope="module")
def schedule_consts(consts):
    problem, _ = consts
    c = fused.FusedConstants.build(problem, solver="schedule")
    assert c.solver == "schedule" and c.plan is None and c.num_steps == 30
    return problem, c


def test_schedule_solve_matches_schedule_oracle(schedule_consts, systems):
    """K1e's program: the same pivots as schedule.solve_numpy (each step's
    pivot magnitude within 1e-5 relative) and x within rtol 1e-4."""
    problem, c = schedule_consts
    f = problem.factored
    s = jsched.build_schedule(f.hx_scatter.reshape(30, 30) != f.hx_C.shape[1])
    assert [st.col for st in s.steps] == c.perm.tolist()
    a, b = systems
    x, pm = _plain(schedule_consts, a, b)
    for i in range(len(a)):
        xo, metrics = _recording(
            lambda: jsched.solve_numpy(s, a[i].copy(), b[i].copy()))
        assert len(metrics) == 30
        for st, metric in zip(s.steps, metrics):
            np.testing.assert_allclose(pm[st.col][i], metric, rtol=1e-5,
                                       err_msg=f"system {i} column {st.col}")
        np.testing.assert_allclose(x[i], xo, rtol=1e-4,
                                   atol=1e-4 * np.abs(xo).max())


def test_schedule_program_layout(schedule_consts):
    """Step s eliminates position s; its candidates are the schedule's
    rows in the interval row order; the kernel plan takes the 30-candidate
    steps (CMAX = 32) and holds no row maps."""
    problem, c = schedule_consts
    f = problem.factored
    s = jsched.build_schedule(f.hx_scatter.reshape(30, 30) != f.hx_C.shape[1])
    assert np.array_equal(c.row_order, jsched.find_interval_row_order(s))
    pos = np.argsort(c.row_order)
    for k, (st, ref) in enumerate(zip(c.stages, s.steps)):
        assert st.level == 0 and st.steps == (k,) and st.cols == (k,)
        assert sorted(st.cands[0]) == list(ref.rows)
        assert list(pos[list(st.cands[0])]) == sorted(pos[list(ref.rows)])
    assert max(len(st.cands[0]) for st in c.stages) == 30
    plan = c.kernel_plan()
    assert tuple(plan[:4]) == (30, c.q, 30, 0)
    steps = plan[plan[5]:plan[5] + 30 * fused.STEP_INTS].reshape(
        30, fused.STEP_INTS)
    assert steps[:, 2].tolist() == [len(st.cands[0]) for st in c.stages]
    assert steps[-1, 4:34].tolist() == list(c.stages[-1].cands[0])
    assert (steps[:, 34:] == -1).all()


def test_unknown_solver_rejected(consts):
    problem, _ = consts
    with pytest.raises(ValueError, match="solver"):
        fused.FusedConstants.build(problem, solver="dense")
