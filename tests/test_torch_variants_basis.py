"""pair_coef_basis "abc" against the JAX package: P_q(t) = (A t + B) t + C
with A = d_a d_b, B = s_a d_b + s_b d_a, C = s_a s_b and d = tgt - s.

Its rounding near t = 1 is absolute, where the two-point basis ("efg") is
exact there: on the reference's problem the JAX kernel found 31 real
solutions under "abc" against 669 under "efg" (its utils/config.py).  The
port reproduces the formulation, defect and all:

* fused.build_pair_coefs(basis="abc") against the JAX package's
  build_pair_coefs, bit for bit (both form the same float32 products in
  the same order, d as a float32 difference);
* fused._fill against the JAX kernel's _fill_P, basis "abc", for the RK
  stages (the rhs half takes (2 A) t + B) and for the corrector, bit for
  bit at seeded t;
* track_plain against the JAX kernel built with basis "abc", in interpret
  mode, in tests/test_torch_tracker.py's two windows and by its rule;
* a CPU engine round at H = 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_tracker as ttt
from test_torch_tracker import _few_threads, end_window, setup  # noqa: F401
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import fused as jfused
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused

_ABC = dict(pair_coef_basis="abc")
_B = 32


@pytest.fixture(scope="module")
def coefficients(setup):  # noqa: F811
    """The round's first _B target parameters, the port's abc
    coefficients (B, 3, Q) and the JAX package's six (Q, B) planes."""
    _, port, jp, _, _, tgt_all = setup
    tgt = tgt_all[:_B]
    diff = tgt - jp.start_params
    f32 = np.float32
    ref = jfused.build_pair_coefs(
        jp, jnp.asarray(diff.real, f32), jnp.asarray(diff.imag, f32), _B,
        jnp.asarray(tgt.real, f32), jnp.asarray(tgt.imag, f32), basis="abc",
        dynamic_start=False)
    got = fused.build_pair_coefs(port, torch.as_tensor(tgt), basis="abc")
    return tgt, got, [np.asarray(a) for a in ref]


def test_abc_coefficients_match_jax(setup, coefficients):  # noqa: F811
    tgt, got, ref = coefficients
    for i in range(3):
        np.testing.assert_array_equal(got[:, i].real.numpy().T, ref[2 * i])
        np.testing.assert_array_equal(got[:, i].imag.numpy().T, ref[2 * i + 1])
    # C is the two-point basis's G (s_a s_b); A and B are not its E and F.
    efg = fused.build_pair_coefs(setup[1], torch.as_tensor(tgt), "efg")
    assert torch.equal(got[:, 2], efg[:, 2])
    assert not torch.equal(got[:, 0], efg[:, 0])


@pytest.mark.parametrize("rk", [True, False], ids=["rk", "corrector"])
def test_fill_matches_fill_P(setup, coefficients, rk):  # noqa: F811
    _, _, jp, _, _, _ = setup
    _, got, _ = coefficients
    jc = jfused.FusedConstants.build(jp, solver="reduced")
    t = np.random.default_rng(5).uniform(0.0, 1.0, _B).astype(np.float32)

    def wide(re, im):
        return np.concatenate([re, im], axis=1)

    agq = jnp.asarray(np.stack([
        jc.ohq23 @ wide(got[:, i].real.numpy().T, got[:, i].imag.numpy().T)
        for i in range(3)]))
    P = np.zeros((jc.kp, 2 * _B), np.float32)
    jfused._fill_P(jc, P, agq, jnp.asarray(np.concatenate([t, t])[None]), rk,
                   basis="abc")
    Pp, Rp = fused._fill(fused.efg_planes(got).unbind(1), torch.as_tensor(t),
                         rk=rk, basis="abc")
    want = np.concatenate([
        (jc.ohq23 @ wide(Pp[0].numpy().T, Pp[1].numpy().T))[:jc.k2p],
        (jc.ohq23 @ wide(Rp[0].numpy().T, Rp[1].numpy().T))[jc.k2p:]])
    np.testing.assert_array_equal(P, want)


@pytest.fixture(scope="module")
def abc(setup):  # noqa: F811
    return ttt._variant_setup(setup, ttt._TR, **_ABC)


def test_start_window_matches_jax_kernel(abc):
    cfg, port, _, c, _, tgt_all = abc
    x = np.ascontiguousarray(np.asarray(port.start_sols)[:ttt._TR][:, c.perm])
    flags = fused.init_flags(cfg.hc, ttt._TR).numpy()
    _, calm, (_, _, _, steps) = ttt._compare_window(abc, x, x, flags,
                                                    tgt_all[:ttt._TR])
    assert calm.sum() >= 0.9 * ttt._TR
    assert int(steps.max()) == ttt._STEPS


def test_end_window_matches_jax_kernel(abc, end_window):  # noqa: F811
    x, xl, fl, tgt = end_window
    stable, calm, (conv, inf, prn, _) = ttt._compare_window(abc, x, xl, fl,
                                                            tgt)
    conv, inf, prn = (a.numpy() & stable for a in (conv, inf, prn))
    assert conv.sum() >= 2 and inf.sum() >= 1 and prn.sum() >= 5
    assert stable.sum() >= 0.75 * ttt._TR and calm.sum() >= 0.5 * ttt._TR


def test_engine_round_runs_the_variant(setup):  # noqa: F811
    ttt._engine_round_matches_track_plain(setup[0], _ABC)
