"""eval_precision "split3_rk2" against the JAX package: the RK stages'
evaluations at 2-term bfloat16 splits, the corrector in float32.

On the TPU every constant matmul of an RK-stage evaluation takes its
input as h + l1, h = bf16(v), l1 = bf16(v - h) (_sdot2; _kdot2 for the
merged structure's gathers, the same rounding): about 16 significant
bits.  The port's plain evaluation (fused._assemble with split2) is held
to the JAX evaluation core with those dots on bfloat16 constants, on
seeded x and pair products, within 1e-6 of each row's magnitude; the
port's float32 evaluation misses that bound (the split moves the values
by about 1e-5 of a row).

The JAX kernel in interpret mode computes plain float32 for every
eval_precision (fused.py:1528 there), so here it is built with its TPU
body: ``_make_kernel`` is wrapped to receive interpret=False while the
pallas_call stays in interpret mode (nothing in the JAX package changes).
Its corrector then runs 3-term splits, float32 up to the order of its
sums.  track_plain is held to that kernel in tests/test_torch_tracker.py's
two windows and by its rule, then under rk_jacobian_reuse too (its -Ht
replays, es_rhs there, take the split as well), and a CPU engine round at
H = 1 runs it.
"""

import numpy as np
import pytest

import test_torch_tracker as ttt
from test_torch_tracker import _few_threads, end_window, setup  # noqa: F401
from test_torch_variants_eval import (
    evaluation_inputs,  # noqa: F401
    jax_system,
    planes,
    port_system,
    row_errors,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import fused as jfused
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused

_SPLIT2 = dict(eval_precision="split3_rk2")
_ROW_TOL = 1e-6


@pytest.mark.parametrize("structure", ["classic", "merged"])
def test_rk_stage_evaluation_matches_sdot2(evaluation_inputs, structure):  # noqa: F811
    jc, c, x, p, r = evaluation_inputs
    want = jax_system(jc, c, structure, x, p, r, want_h=False, split2=True)
    got = port_system(c, x, p, r, want_h=False, split2=True)
    assert row_errors(got, want).max() < _ROW_TOL
    # The float32 evaluation is another function at this bound.
    fp32 = port_system(c, x, p, r, want_h=False)
    assert row_errors(fp32, want).max() > 3 * _ROW_TOL
    # A replay's rhs-only assembly takes the same split.
    tb = fused._Tables(c, "cpu")
    rhs = fused._assemble(
        tb, *(planes(a) for a in (x, p, r)), want_h=False,
        rhs_only=True, split2=True)
    assert np.array_equal(rhs[0].numpy() + 1j * rhs[1].numpy(), got[:, :, 30])


def _tpu_body_setup(setup, **knobs):
    """ttt._variant_setup with the JAX kernel's TPU body (its matmul modes)
    run by the interpreter."""
    make = jfused._make_kernel
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfused, "_make_kernel",
                   lambda *a, **k: make(*a, **{**k, "interpret": False}))
        return ttt._variant_setup(setup, ttt._TR, **knobs)


@pytest.fixture(scope="module")
def split2(setup):  # noqa: F811
    return _tpu_body_setup(setup, **_SPLIT2)


def test_start_window_matches_jax_kernel(split2):
    cfg, port, _, c, _, tgt_all = split2
    x = np.ascontiguousarray(np.asarray(port.start_sols)[:ttt._TR][:, c.perm])
    flags = fused.init_flags(cfg.hc, ttt._TR).numpy()
    _, calm, (_, _, _, steps) = ttt._compare_window(split2, x, x, flags,
                                                    tgt_all[:ttt._TR])
    assert calm.sum() >= 0.9 * ttt._TR
    assert int(steps.max()) == ttt._STEPS


def test_end_window_matches_jax_kernel(split2, end_window):  # noqa: F811
    x, xl, fl, tgt = end_window
    stable, calm, (conv, inf, prn, _) = ttt._compare_window(split2, x, xl,
                                                            fl, tgt)
    conv, inf, prn = (a.numpy() & stable for a in (conv, inf, prn))
    assert conv.sum() >= 2 and inf.sum() >= 1 and prn.sum() >= 5
    assert stable.sum() >= 0.75 * ttt._TR and calm.sum() >= 0.5 * ttt._TR


def test_start_window_with_frozen_rk_stages(setup):  # noqa: F811
    """split3_rk2 under rk_jacobian_reuse (schedule program): stages 2-4
    replay stage 1's elimination on a split -Ht."""
    vs = _tpu_body_setup(setup, rk_jacobian_reuse=True, **_SPLIT2)
    cfg, port, _, c, _, tgt_all = vs
    assert c.solver == "schedule"
    x = np.ascontiguousarray(np.asarray(port.start_sols)[:ttt._TR][:, c.perm])
    flags = fused.init_flags(cfg.hc, ttt._TR).numpy()
    _, calm, (_, _, _, steps) = ttt._compare_window(vs, x, x, flags,
                                                    tgt_all[:ttt._TR])
    assert calm.sum() >= 0.9 * ttt._TR
    assert int(steps.max()) == ttt._STEPS


def test_engine_round_runs_the_variant(setup):  # noqa: F811
    ttt._engine_round_matches_track_plain(setup[0], _SPLIT2)
