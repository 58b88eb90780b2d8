"""track_plain (the CUDA kernel's plain twin) against the JAX package's
fused Pallas kernel, run in interpret mode as the JAX tests run it.

Workload: view 0, hypothesis seed 0.  Two windows of a few HC steps each,
both run by one interpret-mode build of the JAX kernel on resumable
state:

* the start: the first 32 start roots, 4 steps from fresh state;
* the end: 32 paths taken from the port's own run of all roots at
  snapshots every 4 steps from step 28 on, chosen so that the next 4 steps
  hold the events of a path's end -- convergence, divergence and
  TrunPaths pruning -- and then 4 steps from that state.

Both implementations round differently at the ulp level, and a path whose
corrector norm sits at its threshold (near t = 1 the Jacobian can be close
to singular) turns that into a different step.  So each path is first
probed with four 1e-7 relative perturbations of its x and target
parameters through track_plain:

* on every path whose flags no perturbation changes, the flags (all 8
  rows: t, dt, success count, end zone, depth check, inf, pruned, step
  count) must be identical;
* on those paths that no perturbation moves by 1e-4 relative either, x
  must agree within 1e-3 relative (per path, floor 1), the bound of
  tests/test_fused.py.

At the start that must be at least 90 % of the paths.  The end window
holds the ill-conditioned endings on purpose: there at least 75 % must be
flag-stable and half well-conditioned, and the flag-stable ones must still
include convergence, divergence and pruning.

The 12-step window of tests/test_fused.py (its own compile of the JAX
kernel, about a minute on the CPU) runs in the slow tier.

The static-schedule program (solver="schedule", K1e) is held to the JAX
kernel built with the schedule constants in the same two windows: the
start from its own position order, the end from the same path states
carried into its layout (its own perm).  Its flags and step counts equal
the condensed program's on a short run, as tests/test_reduce.py holds the
JAX package's pair.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
    trifocal as jtrifocal,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import fused as jfused
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import data_io
from trifocal_pose_estimation_using_improved_gpuhc_torch import engine
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    _kernels,
    fused,
    ransac,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import config

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")
_TR = 32
_STEPS = 4
_FIRST = 28      # the first snapshot's step: no path ends before
_PERTURBATIONS = 4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads: the tier-1 command runs several pytest workers
    on one CPU, and oversubscribed OpenMP threads slow the many small ops
    of track_plain by orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    cfg = config.EngineConfig(data_root=DATA)
    jcfg = dataclasses.replace(cfg, problem=config.problem_config(cfg))
    port = trifocal.TrifocalProblem.load(cfg)
    jp = jtrifocal.TrifocalProblem.load(jcfg)
    view = data_io.load_ransac_view(config.ransac_data_dir(cfg), 0)
    samples = ransac.sample_edgel_triplets(0, view.edge_locations.shape[0], 1)
    tgt = ransac.build_target_params(view.edge_locations, view.edge_tangents,
                                     samples)
    tgt_all = np.repeat(tgt, port.num_tracks, axis=0)
    c = fused.FusedConstants.build(port)
    jc = jfused.FusedConstants.build(jp, solver="reduced")
    assert np.array_equal(c.perm, np.asarray(jc.perm))
    run = jax.jit(jfused.build_kernel_caller(jc, jp, cfg.hc, _TR, _STEPS,
                                             interpret=True))
    return cfg, port, jp, c, run, tgt_all


def _variant_setup(setup, jax_tile, **knobs):
    """setup's tuple for a variant of the HC config: its constants (the
    schedule program under rk_jacobian_reuse) and the JAX kernel built
    with that config at ``jax_tile`` paths per tile."""
    cfg, port, jp, _, _, tgt_all = setup
    hc = dataclasses.replace(cfg.hc, **knobs)
    solver = fused.solver_of(hc)
    c = fused.FusedConstants.build(port, solver=solver)
    jc = jfused.FusedConstants.build(jp, solver=solver)
    assert np.array_equal(c.perm, np.asarray(jc.perm))
    run = jax.jit(jfused.build_kernel_caller(jc, jp, hc, jax_tile, _STEPS,
                                             interpret=True))
    return dataclasses.replace(cfg, hc=hc), port, jp, c, run, tgt_all


def _jax_steps(setup, x, xl, flags, tgt, niter):
    """The JAX kernel on state (x, xl (B, 30) complex in position order,
    flags (B, 8)); returns the same, as numpy."""
    cfg, _, jp, _, run, _ = setup
    f32 = np.float32
    diff = tgt - jp.start_params
    coefs = jfused.build_pair_coefs(
        jp, jnp.asarray(diff.real, f32), jnp.asarray(diff.imag, f32),
        x.shape[0], jnp.asarray(tgt.real, f32), jnp.asarray(tgt.imag, f32),
        basis=cfg.hc.pair_coef_basis, dynamic_start=False)
    state = tuple(jnp.asarray(np.ascontiguousarray(a.T), f32) for a in
                  (x.real, x.imag, xl.real, xl.imag, flags))
    xr, xi, lr, li, fl = run(state, coefs, jnp.full((1,), niter, jnp.int32))
    return ((np.asarray(xr) + 1j * np.asarray(xi)).T.astype(np.complex64),
            (np.asarray(lr) + 1j * np.asarray(li)).T.astype(np.complex64),
            np.asarray(fl).T)


def _compare_window(setup, x, xl, flags, tgt, excuse=None):
    """_STEPS steps from the given state in both; flags identical and x
    close on the well-conditioned paths.  ``excuse(i)``, if given, may
    exempt a flag-stable path i whose flags differ: it must prove that the
    path's outcome is not determined in float32 (it returns True), else
    the comparison fails."""
    cfg, port, _, c, _, _ = setup
    hc = cfg.hc

    def plain(x, tgt):
        efg = fused.build_pair_coefs(port, torch.as_tensor(tgt),
                                     hc.pair_coef_basis)
        gx, _, gfl = fused.track_plain(c, hc, torch.as_tensor(x),
                                       torch.as_tensor(xl),
                                       torch.as_tensor(flags), efg,
                                       niter=_STEPS)
        return gx.numpy(), gfl.numpy()

    gx, gfl = plain(x, tgt)
    rx, _, rfl = _jax_steps(setup, x, xl, flags, tgt, _STEPS)
    # Per path, so that a diverging path's huge x sets no other's bound.
    scale = np.maximum(np.abs(rx).max(axis=1), 1.0)
    stable = np.ones(len(x), bool)   # flags unmoved by every perturbation
    calm = np.isfinite(gx).all(axis=1) & np.isfinite(rx).all(axis=1)
    for seed in range(_PERTURBATIONS):
        rng = np.random.default_rng(seed)

        def nudge(a):
            return (a * (1 + 1e-7 * rng.standard_normal(a.shape))).astype(
                a.dtype)

        mx, mfl = plain(nudge(x), nudge(tgt))
        stable &= (mfl == gfl).all(axis=1)
        calm &= np.abs(mx - gx).max(axis=1) / scale < 1e-4
    if excuse is not None:
        for i in np.flatnonzero(stable & (gfl != rfl).any(axis=1)):
            assert excuse(int(i)), f"path {i}: flags differ"
            stable[i] = False
    calm &= stable
    np.testing.assert_array_equal(gfl[stable], rfl[stable])
    assert (np.abs(gx - rx).max(axis=1) / scale)[calm].max() < 1e-3
    return stable, calm, fused.flags_outputs(hc, torch.as_tensor(gfl))


def test_start_window_matches_jax_kernel(setup):
    cfg, port, _, c, _, tgt_all = setup
    x = np.ascontiguousarray(np.asarray(port.start_sols)[:_TR][:, c.perm])
    flags = fused.init_flags(cfg.hc, _TR).numpy()
    stable, calm, (_, _, _, steps) = _compare_window(setup, x, x, flags,
                                                     tgt_all[:_TR])
    assert calm.sum() >= 0.9 * _TR
    assert int(steps.max()) == _STEPS  # every path took every step


@pytest.fixture(scope="module")
def end_window(setup):
    """32 path states from the port's run of all roots, snapshotted every
    _STEPS steps from step _FIRST on: every path that converges or
    diverges in the window after a snapshot, then those pruned in it,
    then the active paths closest to t = 1."""
    cfg, port, _, c, _, tgt_all = setup
    hc = cfg.hc
    efg = fused.build_pair_coefs(port, torch.as_tensor(tgt_all),
                                 hc.pair_coef_basis)
    perm = torch.as_tensor(c.perm, dtype=torch.long)
    x = torch.as_tensor(port.start_sols)[:, perm].contiguous()
    state = fused.track_plain(c, hc, x, x, fused.init_flags(hc, x.shape[0]),
                              efg, niter=_FIRST)
    picks = []  # (priority, -t, snapshot index, path)
    snaps = []
    while int(state[2][:, 7].max()) + _STEPS <= hc.max_steps + 1:
        conv, inf, prn, _ = fused.flags_outputs(hc, state[2])
        active = ~conv & ~inf & ~prn
        nxt = fused.track_plain(c, hc, *state, efg, niter=_STEPS)
        c2, i2, p2, _ = fused.flags_outputs(hc, nxt[2])
        rank = torch.where((c2 | i2) & active, 0,
                           torch.where(p2 & active, 1, 2))
        for i in active.nonzero()[:, 0].tolist():
            picks.append((int(rank[i]), -float(state[2][i, 0]), len(snaps), i))
        snaps.append(state)
        state = nxt
    picks.sort()
    chosen = picks[:_TR]
    x, xl, fl = (np.stack([snaps[s][k][i].numpy() for _, _, s, i in chosen])
                 for k in range(3))
    tg = np.stack([tgt_all[i] for _, _, _, i in chosen])
    return x, xl, fl, tg


def test_end_window_matches_jax_kernel(setup, end_window):
    x, xl, fl, tgt = end_window
    stable, calm, (conv, inf, prn, _) = _compare_window(setup, x, xl, fl,
                                                        tgt)
    # The events were compared: on flag-stable paths, the window holds
    # convergence, divergence and pruning.
    conv, inf, prn = (a.numpy() & stable for a in (conv, inf, prn))
    assert conv.sum() >= 2 and inf.sum() >= 1 and prn.sum() >= 5
    assert stable.sum() >= 0.75 * _TR and calm.sum() >= 0.5 * _TR


@pytest.mark.slow
def test_track_plain_matches_jax_kernel_12_steps(setup):
    """The whole tracker from fresh state, as tests/test_fused.py runs the
    JAX kernel: 12 steps on the first 32 roots."""
    cfg, port, jp, _, _, tgt_all = setup
    hc = dataclasses.replace(cfg.hc, max_steps=12)
    x0 = np.asarray(port.start_sols)[:_TR]
    tgt = tgt_all[:_TR]
    ref = jfused.make_track_fn(jp, hc, tile=_TR, interpret=True)(
        x0, tgt, tgt - jp.start_params)
    track = fused.make_track_fn(port, hc)
    got = track(torch.as_tensor(x0), torch.as_tensor(tgt))
    for f in ("num_steps", "converged", "pruned", "inf_fail"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(ref, f))
    assert int(got.num_steps.max()) == 13
    x = got.x.numpy()
    scale = max(np.abs(ref.x).max(), 1.0)
    noise = np.random.default_rng(7).standard_normal(x0.shape)
    moved = track(torch.as_tensor((x0 * (1 + 1e-7 * noise)).astype(x0.dtype)),
                  torch.as_tensor(tgt)).x.numpy()
    calm = np.abs(moved - x).max(axis=1) / scale < 1e-4
    assert calm.sum() >= 0.9 * _TR
    assert np.abs(x - ref.x)[calm].max() / scale < 1e-3


def test_track_plain_resumes(setup):
    """Two segments of steps on carried state equal one run."""
    cfg, port, _, c, _, tgt_all = setup
    hc = dataclasses.replace(cfg.hc, max_steps=7)
    perm = torch.as_tensor(c.perm, dtype=torch.long)
    x = torch.as_tensor(np.asarray(port.start_sols)[:_TR])[:, perm].contiguous()
    efg = fused.build_pair_coefs(port, torch.as_tensor(tgt_all[:_TR]),
                                 hc.pair_coef_basis)
    fl = fused.init_flags(hc, _TR)
    one = fused.track_plain(c, hc, x, x, fl, efg, niter=8)
    a = fused.track_plain(c, hc, x, x, fl, efg, niter=3)
    two = fused.track_plain(c, hc, *a, efg, niter=5)
    for u, v in zip(one, two):
        assert torch.equal(u, v)


def test_kernel_wrapper_refuses_cpu_tensors(setup):
    """The kernel binding never runs a plain fallback: CPU tensors raise."""
    cfg, port, _, c, _, tgt_all = setup
    x = torch.as_tensor(np.asarray(port.start_sols)[:_TR])
    efg = fused.build_pair_coefs(port, torch.as_tensor(tgt_all[:_TR]),
                                 cfg.hc.pair_coef_basis)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.hc_track(x, x.clone(), fused.init_flags(cfg.hc, _TR), efg,
                          torch.as_tensor(c.kernel_plan()), 4, cfg.hc)
    assert _kernels.hc_track.launches == 0


@pytest.fixture(scope="module")
def schedule_setup(setup):
    """setup's tuple for the schedule program: its constants and the JAX
    kernel built from the JAX package's schedule constants."""
    cfg, port, jp, _, _, tgt_all = setup
    c = fused.FusedConstants.build(port, solver="schedule")
    jc = jfused.FusedConstants.build(jp, solver="schedule")
    assert jc.reduced is None
    assert np.array_equal(c.perm, np.asarray(jc.perm))
    assert np.array_equal(c.row_order, np.asarray(jc.row_order))
    hc = dataclasses.replace(cfg.hc, solver="schedule")
    run = jax.jit(jfused.build_kernel_caller(jc, jp, hc, _TR, _STEPS,
                                             interpret=True))
    return dataclasses.replace(cfg, hc=hc), port, jp, c, run, tgt_all


def _to_layout(x, src, dst):
    """Position-order states of program src moved to program dst's order."""
    return np.ascontiguousarray(x[:, np.argsort(src.perm)][:, dst.perm])


def test_schedule_start_window_matches_jax_kernel(schedule_setup):
    cfg, port, _, c, _, tgt_all = schedule_setup
    x = np.ascontiguousarray(np.asarray(port.start_sols)[:_TR][:, c.perm])
    flags = fused.init_flags(cfg.hc, _TR).numpy()
    stable, calm, (_, _, _, steps) = _compare_window(schedule_setup, x, x,
                                                     flags, tgt_all[:_TR])
    assert calm.sum() >= 0.9 * _TR
    assert int(steps.max()) == _STEPS


def test_schedule_end_window_matches_jax_kernel(setup, schedule_setup,
                                                end_window):
    x, xl, fl, tgt = end_window
    c_r, c_s = setup[3], schedule_setup[3]
    stable, calm, (conv, inf, prn, _) = _compare_window(
        schedule_setup, _to_layout(x, c_r, c_s), _to_layout(xl, c_r, c_s),
        fl, tgt)
    conv, inf, prn = (a.numpy() & stable for a in (conv, inf, prn))
    assert conv.sum() >= 2 and inf.sum() >= 1 and prn.sum() >= 5
    assert stable.sum() >= 0.75 * _TR and calm.sum() >= 0.5 * _TR


def test_reduced_and_schedule_programs_agree(setup, schedule_setup):
    """The two programs make the same pivots and updates; only the order
    of the back-substitution sums differs.  On the first _TR roots over 12
    steps every flag row (t, dt, success count, ..., step count) is equal,
    and x within 1e-3 relative."""
    cfg, port, _, c_r, _, tgt_all = setup
    c_s = schedule_setup[3]
    hc = cfg.hc
    efg = fused.build_pair_coefs(port, torch.as_tensor(tgt_all[:_TR]),
                                 hc.pair_coef_basis)
    x0 = np.asarray(port.start_sols)[:_TR]
    fl = fused.init_flags(hc, _TR)

    def run(c):
        x = torch.as_tensor(np.ascontiguousarray(x0[:, c.perm]))
        gx, _, gfl = fused.track_plain(c, hc, x, x, fl, efg, niter=12)
        return gx.numpy()[:, np.argsort(c.perm)], gfl.numpy()

    (xr, flr), (xs, fls) = run(c_r), run(c_s)
    np.testing.assert_array_equal(flr, fls)
    assert int(flr[:, fused._F_NST].max()) == 12
    scale = np.maximum(np.abs(xr).max(axis=1), 1.0)
    assert (np.abs(xr - xs).max(axis=1) / scale).max() < 1e-3


def _engine_round_matches_track_plain(cfg, knobs, segmented_plain=None):
    """A CPU engine round at H = 1 under the variant against a direct
    track_plain call (or ``segmented_plain(problem, hc, x0, tgt)``): the
    same flags and step counts on every path."""
    hc = dataclasses.replace(cfg.hc, max_steps=16, **knobs)
    cfg = dataclasses.replace(cfg, hc=hc)
    eng = engine.TrifocalPoseEngine(cfg, device="cpu")
    view = eng.load_view(0)
    rr = eng.run_round(view, seed=0, num_hypotheses=1)
    s = ransac.sample_edgel_triplets(0, view.edge_locations.shape[0], 1)
    tgt = torch.as_tensor(ransac.build_target_params(
        view.edge_locations, view.edge_tangents, s)).repeat_interleave(
            eng.problem.num_tracks, dim=0)
    x0 = eng._start
    if segmented_plain is None:
        ref = fused.make_plain_track_fn(eng.problem, hc)(x0, tgt)
    else:
        ref = segmented_plain(eng.problem, hc, x0, tgt)
    for f in ("converged", "inf_fail", "pruned", "num_steps"):
        np.testing.assert_array_equal(np.asarray(getattr(rr, f)),
                                      getattr(ref, f).numpy(), err_msg=f)
    assert int(ref.num_steps.max()) == hc.max_steps + 1
