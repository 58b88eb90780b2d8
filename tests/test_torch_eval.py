"""The port's evaluators against the JAX package's ops/eval.py.

Inputs are random complex x, p(t) and target - start, made from a seed
with numpy.  Tolerance rtol = atol = 2e-4, the bound the reference's own
evaluator tests use (tests/test_generic_problem.py): both sides sum the
same float32 products in different orders.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
    trifocal as jtrifocal,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import eval as jev
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import eval as ev
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import config

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")
TOL = dict(rtol=2e-4, atol=2e-4)
_B = 8


@pytest.fixture(scope="module")
def problems():
    cfg = config.EngineConfig(data_root=DATA)
    jcfg = dataclasses.replace(cfg, problem=config.problem_config(cfg))
    return trifocal.TrifocalProblem.load(cfg), jtrifocal.TrifocalProblem.load(jcfg)


@pytest.fixture(scope="module")
def inputs(problems):
    rng = np.random.default_rng(7)

    def c(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    x = c(_B, 30)
    tgt = c(_B, 34)
    tgt[:, 33] = 1.0
    t = rng.uniform(0.0, 1.0, _B).astype(np.float32)
    return x, tgt, t


def _jax_eval(jp, x, tgt, t):
    p = jev.param_homotopy(jnp.asarray(t), jp.start_params, jnp.asarray(tgt))
    diff = tgt - jp.start_params
    out = jev.eval_all_factored(jp, jnp.asarray(x), p, jnp.asarray(diff))
    return [np.array(a) for a in out], np.array(p), diff


def test_param_homotopy_matches(problems, inputs):
    port, jp = problems
    x, tgt, t = inputs
    _, p_ref, _ = _jax_eval(jp, x, tgt, t)
    p = ev.param_homotopy(torch.as_tensor(t),
                          torch.as_tensor(port.start_params),
                          torch.as_tensor(tgt))
    np.testing.assert_allclose(p.numpy(), p_ref, rtol=1e-6, atol=1e-6)


def test_factored_matches_jax(problems, inputs):
    port, jp = problems
    x, tgt, t = inputs
    (hx_r, h_r, mht_r), p, diff = _jax_eval(jp, x, tgt, t)
    hx, h, mht = ev.eval_all_factored(
        port, torch.as_tensor(x), torch.as_tensor(p), torch.as_tensor(diff))
    np.testing.assert_allclose(hx.numpy(), hx_r, **TOL)
    np.testing.assert_allclose(h.numpy(), h_r, **TOL)
    np.testing.assert_allclose(mht.numpy(), mht_r, **TOL)


@pytest.mark.parametrize("which", ["H", "Hx", "minus_Ht"])
def test_direct_matches_factored(problems, inputs, which):
    port, jp = problems
    x, tgt, t = inputs
    _, p, diff = _jax_eval(jp, x, tgt, t)
    xt, pt, dt = (torch.as_tensor(a) for a in (x, p, diff))
    hx, h, mht = ev.eval_all_factored(port, xt, pt, dt)
    if which == "H":
        got, want = ev.eval_H_direct(port, xt, pt), h
    elif which == "Hx":
        got, want = ev.eval_Hx_direct(port, xt, pt), hx
    else:
        got, want = ev.eval_minus_Ht_direct(port, xt, pt, dt), mht
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("rk", [True, False])
def test_kernel_form_matches_jax(problems, inputs, rk):
    """The tracker's own evaluation (two-point pair basis, position
    order, augmented (30, 32) layout) against the JAX factored evaluator:
    Hx and -Ht for RK stages, Hx and H for the corrector."""
    port, jp = problems
    x, tgt, t = inputs
    (hx_r, h_r, mht_r), _, _ = _jax_eval(jp, x, tgt, t)
    c = fused.FusedConstants.build(port)
    tb = fused._Tables(c, "cpu")
    efg = fused.efg_planes(fused.build_pair_coefs(port, torch.as_tensor(tgt),
                                                  "efg"))
    P, R = fused._fill(efg.unbind(1), torch.as_tensor(t), rk=rk, basis="efg")
    xpos = torch.as_tensor(x)[:, torch.as_tensor(c.perm, dtype=torch.long)]
    mr, mi = fused._assemble(tb, (xpos.real, xpos.imag), P, R,
                             want_h=not rk)
    m = torch.complex(mr, mi).numpy()
    hx_perm = hx_r[:, c.row_order][:, :, c.perm]
    rhs = (mht_r if rk else h_r)[:, c.row_order]
    np.testing.assert_allclose(m[:, :, :30], hx_perm, **TOL)
    np.testing.assert_allclose(m[:, :, 30], rhs, **TOL)
    assert np.all(m[:, :, 31] == 0)


def test_pair_basis_exact_at_t1(problems, inputs):
    """P(t = 1) is exactly E = tgt_a tgt_b (the two-point basis)."""
    port, _ = problems
    _, tgt, _ = inputs
    efg = fused.build_pair_coefs(port, torch.as_tensor(tgt), "efg")
    P, _ = fused._fill(fused.efg_planes(efg).unbind(1), torch.ones(_B),
                       rk=False, basis="efg")
    assert torch.equal(torch.complex(*P), efg[:, 0])
