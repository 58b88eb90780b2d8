"""The kept-elimination replay and the modified-Newton corrector against
the JAX package.

ops/fused.resolve_plain replays an elimination that factor_plain kept on
a new right-hand side: each step applies its multipliers to the rhs
column alone, with the forward pass's own update, and back-substitutes
(the JAX package's _resolve_rhs and _reduce_resolve_rhs).  On seeded
systems with the Jacobian's sparsity and a realistic magnitude spread
(columns scaled by 10^U(-2, 3), as tests/test_fused.py scales the
parameter products), for both solve programs:

* on the rhs the elimination started from, the replay gives solve_plain's
  x bit for bit;
* on a fresh rhs it gives the JAX package's host oracle's x
  (reduce.solve_numpy, schedule.solve_numpy: the same pivots, since they
  depend on the matrix alone) within 1e-5 relative.

corrector_jacobian_reuse (CJR) k = 1 and 2: corrector iterations from the
k-th on replay the last full iteration's elimination.  Each runs
track_plain against the JAX kernel built with that config in interpret
mode, in tests/test_torch_tracker.py's two windows and by its rule.  CJR
converges worse than full Newton, yet keeps the default's bounds (measured
at the end: 30 and 29 flag-stable paths, 19 and 18 calm, of 32).  Then a
CPU engine round at H = 1 under each, as in
tests/test_torch_variants_predictor.py.
"""

import numpy as np
import pytest
import torch

import test_torch_tracker as ttt
from test_torch_tracker import _few_threads, end_window, setup  # noqa: F401
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import reduce as redu
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import (
    schedule as jsched,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused

_B = 16
_VARIANTS = {"cjr1": dict(corrector_jacobian_reuse=1),
             "cjr2": dict(corrector_jacobian_reuse=2)}


def _pattern(problem):
    f = problem.factored
    return f.hx_scatter.reshape(30, 30) != f.hx_C.shape[1]


@pytest.fixture(scope="module")
def systems(setup):  # noqa: F811
    """(A (B, 30, 30), b, fresh b) complex64, seeded."""
    port = setup[1]
    rng = np.random.default_rng(23)
    shape = (_B, 30, 30)
    a = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
         * _pattern(port) * 10.0 ** rng.uniform(-2, 3, (_B, 1, 30)))
    b, b2 = rng.standard_normal((2, _B, 30)) + 1j * rng.standard_normal(
        (2, _B, 30))
    return tuple(v.astype(np.complex64) for v in (a, b, b2))


def _augmented(c, a, b):
    """(re, im) augmented systems in the constants' row and column order."""
    m = np.zeros((len(a), 30, fused.WIDTH), np.complex64)
    m[:, :, :30] = a[:, c.row_order][:, :, c.perm]
    m[:, :, 30] = b[:, c.row_order]
    return torch.as_tensor(m.real.copy()), torch.as_tensor(m.imag.copy())


def _rows(c, b):
    b = b[:, c.row_order]
    return torch.as_tensor(b.real.copy()), torch.as_tensor(b.imag.copy())


@pytest.mark.parametrize("solver", ["reduced", "schedule"])
def test_replay_on_its_own_rhs_is_the_solve(setup, systems, solver):  # noqa: F811
    c = fused.FusedConstants.build(setup[1], solver=solver)
    tb = fused._Tables(c, "cpu")
    a, b, _ = systems
    x = fused.solve_plain(tb, _augmented(c, a, b))
    kept = fused.factor_plain(tb, _augmented(c, a, b))
    xk = fused.backsub_plain(tb, kept.mr, kept.mi, kept.piv)
    xr = fused.resolve_plain(tb, kept, _rows(c, b))
    for u, v, w in zip(x, xk, xr):
        assert torch.equal(u, v) and torch.equal(u, w)
    assert bool(torch.isfinite(x[0]).all())


@pytest.mark.parametrize("solver", ["reduced", "schedule"])
def test_replay_on_a_fresh_rhs_matches_the_oracle(setup, systems, solver):  # noqa: F811
    port = setup[1]
    c = fused.FusedConstants.build(port, solver=solver)
    tb = fused._Tables(c, "cpu")
    a, b, b2 = systems
    kept = fused.factor_plain(tb, _augmented(c, a, b))
    x = torch.complex(*fused.resolve_plain(tb, kept, _rows(c, b2)))
    x = x.numpy()[:, np.argsort(c.perm)]
    if solver == "reduced":
        def oracle(i):
            return redu.solve_numpy(c.plan, a[i].copy(), b2[i].copy())
    else:
        sched = jsched.build_schedule(_pattern(port))

        def oracle(i):
            return jsched.solve_numpy(sched, a[i].copy(), b2[i].copy())
    for i in range(_B):
        xo = oracle(i)
        assert np.abs(x[i] - xo).max() <= 1e-5 * np.abs(xo).max(), i


@pytest.fixture(scope="module")
def variants(setup):  # noqa: F811
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = ttt._variant_setup(setup, ttt._TR, **_VARIANTS[name])
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(_VARIANTS))
def test_start_window_matches_jax_kernel(variants, name):
    vs = variants(name)
    cfg, port, _, c, _, tgt_all = vs
    x = np.ascontiguousarray(np.asarray(port.start_sols)[:ttt._TR][:, c.perm])
    flags = fused.init_flags(cfg.hc, ttt._TR).numpy()
    _, calm, (_, _, _, steps) = ttt._compare_window(vs, x, x, flags,
                                                    tgt_all[:ttt._TR])
    assert calm.sum() >= 0.9 * ttt._TR
    assert int(steps.max()) == ttt._STEPS


@pytest.mark.parametrize("name", list(_VARIANTS))
def test_end_window_matches_jax_kernel(variants, end_window, name):  # noqa: F811
    x, xl, fl, tgt = end_window
    stable, calm, (conv, inf, prn, _) = ttt._compare_window(
        variants(name), x, xl, fl, tgt)
    conv, inf, prn = (a.numpy() & stable for a in (conv, inf, prn))
    assert conv.sum() >= 2 and inf.sum() >= 1 and prn.sum() >= 5
    assert stable.sum() >= 0.75 * ttt._TR and calm.sum() >= 0.5 * ttt._TR


@pytest.mark.parametrize("name", list(_VARIANTS))
def test_engine_round_runs_the_variant(setup, name):  # noqa: F811
    ttt._engine_round_matches_track_plain(setup[0], _VARIANTS[name])
