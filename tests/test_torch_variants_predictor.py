"""The predictor variants of the tracker against the JAX package: predictor
"rk2" (the midpoint rule), "rk3" (Kutta's third-order rule) and
rk_jacobian_reuse (RKJ: RK stages 2-4 replay stage 1's elimination on a
fresh -Ht, on the schedule program).

Each runs ops/fused.track_plain (the CUDA kernel's plain twin) against the
JAX kernel built with the same HC config, in interpret mode, in
tests/test_torch_tracker.py's two windows (view 0, seed 0) and by that
file's rule: flags identical on the paths no 1e-7 perturbation moves, x
within 1e-3 relative on the calm ones.  At the start at least 90 % of the
paths are calm; at the end at least 75 % are flag-stable and half calm, as
for the default config.  RKJ converges worse, and in the end window taken
from the default run it sends no flag-stable path to infinity (measured:
30 flag-stable, 25 calm, 3 converged, 18 pruned); the other two keep the
default's events.

Then the engine: a CPU round at H = 1 (max_steps cut to 16, so that it
takes seconds) under each variant gives the flags and step counts of one
direct track_plain call with that config.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_tracker as ttt
from test_torch_tracker import _few_threads, end_window, setup  # noqa: F401
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused

_VARIANTS = {"rk2": dict(predictor="rk2"), "rk3": dict(predictor="rk3"),
             "rkj": dict(rk_jacobian_reuse=True)}
# Least flag-stable (converged, inf, pruned) paths in the end window.
_END_EVENTS = {"rk2": (2, 1, 5), "rk3": (2, 1, 5), "rkj": (2, 0, 5)}


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
    assert c.solver == ("schedule" if name == "rkj" else "reduced")
    x = np.ascontiguousarray(np.asarray(port.start_sols)[:ttt._TR][:, c.perm])
    flags = fused.init_flags(cfg.hc, ttt._TR).numpy()
    _, calm, (_, _, _, steps) = ttt._compare_window(vs, x, x, flags,
                                                    tgt_all[:ttt._TR])
    assert calm.sum() >= 0.9 * ttt._TR
    assert int(steps.max()) == ttt._STEPS


@pytest.mark.parametrize("name", list(_VARIANTS))
def test_end_window_matches_jax_kernel(setup, variants, end_window,  # noqa: F811
                                       name):
    x, xl, fl, tgt = end_window
    vs = variants(name)
    c_r, c_v = setup[3], vs[3]
    stable, calm, (conv, inf, prn, _) = ttt._compare_window(
        vs, ttt._to_layout(x, c_r, c_v), ttt._to_layout(xl, c_r, c_v), fl,
        tgt)
    conv, inf, prn = (a.numpy() & stable for a in (conv, inf, prn))
    least = _END_EVENTS[name]
    assert conv.sum() >= least[0] and inf.sum() >= least[1] \
        and prn.sum() >= least[2]
    assert stable.sum() >= 0.75 * ttt._TR and calm.sum() >= 0.5 * ttt._TR


@pytest.mark.parametrize("name", list(_VARIANTS))
def test_engine_round_runs_the_variant(setup, name):  # noqa: F811
    ttt._engine_round_matches_track_plain(setup[0], _VARIANTS[name])


def test_rkj_refuses_the_condensed_program(setup):  # noqa: F811
    """RKJ runs on the schedule program only, as in the JAX package: the
    tracker builds the schedule constants for it, and the plain tracker
    (like the kernel's wrapper) refuses condensed ones."""
    cfg, port, _, c_reduced, _, tgt_all = setup
    hc = dataclasses.replace(cfg.hc, rk_jacobian_reuse=True)
    assert fused.make_plain_track_fn(port, hc).constants.solver == "schedule"
    x = torch.as_tensor(np.asarray(port.start_sols)[:2][:, c_reduced.perm])
    efg = fused.build_pair_coefs(port, torch.as_tensor(tgt_all[:2]),
                                 hc.pair_coef_basis)
    with pytest.raises(ValueError, match="schedule"):
        fused.track_plain(c_reduced, hc, x, x, fused.init_flags(hc, 2), efg,
                          niter=1)
