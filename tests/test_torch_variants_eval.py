"""The evaluation structures of the JAX kernel, eval_structure "gathered"
and "merged", against the port.

On the TPU they are other matmul forms of the classic evaluation: one
one-hot gather of [x2 | x3] in place of two (x2 times an exact 1 + 0i),
and for "merged" one block-diagonal fold for Hx and the rhs.  In float32
without contraction every value equals classic's, so the port runs its
one evaluation (and the kernel its classic build) for both.  Shown here:

* the JAX package's evaluation cores (_eval_core, _eval_core_gathered,
  _eval_core_merged, plain float32 dots) against the port's evaluation on
  seeded x and pair products, within 1e-6 of each row's magnitude (both
  sum the same float32 products in other orders; measured about 1.5e-7);
* track_plain against the JAX kernel built with each structure, in
  interpret mode, in tests/test_torch_tracker.py's two windows and by its
  rule.  The JAX kernel's structures are not bit-identical to its classic
  one in interpret mode either (XLA fuses and contracts the restructured
  graphs otherwise, its _eval_core_gathered says), and in the end window
  "merged" ends one flag-stable path a step later than classic does, at
  t = 1 - 1.2e-7.  A path whose flags differ is exempt only where the JAX
  kernel's classic structure, the same function, ends it as the port
  does, and at most one path is;
* a CPU engine round at H = 1 under each, as for the step variants.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_tracker as ttt
from test_torch_tracker import _few_threads, end_window, setup  # noqa: F401
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import fused as jfused
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused

_STRUCTURES = ("gathered", "merged")
_B = 8
_ROW_TOL = 1e-6


def _wide(a):
    """(B, K) complex -> the JAX kernel's (K, 2B) [re | im] planes."""
    return np.concatenate([a.real.T, a.imag.T], axis=1).astype(np.float32)


def jax_system(jc, c, structure, x, p, r, want_h, split2=False):
    """The JAX evaluation core of ``structure`` (constants jc) at
    position-order x (B, 30) with pair products p (Hx half) and r (rhs
    half), (B, Q) complex, laid out as the port's augmented systems (port
    constants c): (B, 30, 31) complex, the Hx nonzeros at their (row,
    position) and the rhs in column 30.  The JAX fold's Hx rows are the
    port's nonzeros in its order (tests/test_torch_problem.py holds the
    fold matrices equal).

    ``split2``: the RK stages' dots under "split3_rk2" on bfloat16
    constants (_sdot2; under "merged" _kdot2 for the gathers on the
    tripled constants, _sdot2 for the fold), else plain float32."""
    B = len(x)
    P = np.concatenate([(jc.ohq23 @ _wide(p))[:jc.k2p],
                        (jc.ohq23 @ _wide(r))[jc.k2p:]])
    hom = np.concatenate([np.ones((1, B)), np.zeros((1, B))], axis=1)
    xp = np.concatenate([_wide(x), hom]).astype(np.float32)
    if structure == "merged":
        fn, consts = jfused._eval_core_merged, [jc.ohx23, jc.ohg, jc.fold_h,
                                                jc.fold_t]
        if split2:
            consts[:2] = [np.concatenate([a] * 3, axis=1) for a in consts[:2]]
            dots = dict(dot_g=jfused._kdot2, dot_f=jfused._sdot2)
        else:
            dots = dict(dot_g=jfused._dot, dot_f=jfused._dot)
    else:
        if structure == "gathered":
            fn, consts = jfused._eval_core_gathered, [jc.ohx23, jc.ohg]
        else:
            fn, consts = jfused._eval_core, [jc.ohx23, jc.ohx2g, jc.ohx3g]
        consts += [jc.chx, jc.cht, jc.chtneg]
        dots = dict(dot=jfused._sdot2 if split2 else jfused._dot)
    dtype = jnp.bfloat16 if split2 else jnp.float32
    hx, rhs = fn(jc, tuple(jnp.asarray(a, dtype) for a in consts),
                 jnp.asarray(P), jnp.asarray(xp), B, want_h, **dots)
    hx, rhs = np.asarray(hx), np.asarray(rhs)
    m = np.zeros((B, 30, 31), np.complex64)
    rows, cols = c.nz_row, c.nz_col
    m[:, rows, cols] = (hx[:len(rows), :B] + 1j * hx[:len(rows), B:]).T
    m[:, :, 30] = (rhs[:, :B] + 1j * rhs[:, B:]).T
    return m


def planes(a):
    """complex numpy -> (re, im) float32 tensors."""
    return torch.as_tensor(a.real.copy()), torch.as_tensor(a.imag.copy())


def port_system(c, x, p, r, want_h, split2=False):
    """fused._assemble on the same inputs, (B, 30, 31) complex."""
    mr, mi = fused._assemble(fused._Tables(c, "cpu"), planes(x), planes(p),
                             planes(r), want_h, split2=split2)
    return torch.complex(mr, mi).numpy()[:, :, :31]


def row_errors(got, want):
    """Per system row: max |got - want| over the row's entries, over the
    row's magnitude."""
    return np.abs(got - want).max(axis=2) / np.abs(want).max(axis=2)


@pytest.fixture(scope="module")
def evaluation_inputs(setup):  # noqa: F811
    """The JAX constants, the port's, and seeded x (B, 30) and pair
    products p, r (B, Q)."""
    _, port, jp, c, _, _ = setup
    jc = jfused.FusedConstants.build(jp, solver="reduced")
    rng = np.random.default_rng(11)

    def cx(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    return jc, c, cx(_B, 30), cx(_B, c.q), cx(_B, c.q)


@pytest.mark.parametrize("want_h", [False, True], ids=["rk", "corrector"])
@pytest.mark.parametrize("structure", ("classic",) + _STRUCTURES)
def test_evaluation_matches_jax_structure(evaluation_inputs, structure,
                                          want_h):
    jc, c, x, p, r = evaluation_inputs
    want = jax_system(jc, c, structure, x, p, r, want_h)
    got = port_system(c, x, p, r, want_h)
    assert row_errors(got, want).max() < _ROW_TOL


@pytest.fixture(scope="module")
def structures(setup):  # noqa: F811
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = ttt._variant_setup(setup, ttt._TR,
                                             eval_structure=name)
        return cache[name]

    return get


@pytest.mark.parametrize("name", _STRUCTURES)
def test_start_window_matches_jax_kernel(structures, name):
    vs = structures(name)
    cfg, port, _, c, _, tgt_all = vs
    x = np.ascontiguousarray(np.asarray(port.start_sols)[:ttt._TR][:, c.perm])
    flags = fused.init_flags(cfg.hc, ttt._TR).numpy()
    _, calm, (_, _, _, steps) = ttt._compare_window(vs, x, x, flags,
                                                    tgt_all[:ttt._TR])
    assert calm.sum() >= 0.9 * ttt._TR
    assert int(steps.max()) == ttt._STEPS


@pytest.mark.parametrize("name", _STRUCTURES)
def test_end_window_matches_jax_kernel(setup, structures, end_window,  # noqa: F811
                                       name):
    x, xl, fl, tgt = end_window
    vs = structures(name)
    cfg, port, _, c, _, _ = vs
    _, _, gfl = fused.track_plain(
        c, cfg.hc, *(torch.as_tensor(a) for a in (x, xl, fl)),
        fused.build_pair_coefs(port, torch.as_tensor(tgt),
                               cfg.hc.pair_coef_basis), niter=ttt._STEPS)
    _, _, own = ttt._jax_steps(vs, x, xl, fl, tgt, ttt._STEPS)
    dropped = []

    def excuse(i):
        dropped.append(i)
        _, _, classic = ttt._jax_steps(setup, x, xl, fl, tgt, ttt._STEPS)
        return bool((classic[i] == gfl.numpy()[i]).all()
                    and (classic[i] != own[i]).any())

    stable, calm, (conv, inf, prn, _) = ttt._compare_window(
        vs, x, xl, fl, tgt, excuse=excuse)
    assert len(dropped) <= 1
    conv, inf, prn = (a.numpy() & stable for a in (conv, inf, prn))
    assert conv.sum() >= 2 and inf.sum() >= 1 and prn.sum() >= 5
    assert stable.sum() >= 0.75 * ttt._TR and calm.sum() >= 0.5 * ttt._TR


@pytest.mark.parametrize("name", _STRUCTURES)
def test_engine_round_runs_the_variant(setup, name):  # noqa: F811
    ttt._engine_round_matches_track_plain(setup[0],
                                          dict(eval_structure=name))
