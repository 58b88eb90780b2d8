"""The corrector -> predictor handoff (predictor_handoff, CPH) against the
JAX package: RK stage 1 replays the previous step's last full corrector
elimination on the fresh -Ht, where no path of the tile rolled back in
that step.

The JAX kernel decides the handoff once per tile of HCConfig.tile paths
(every active lane of the tile advanced); the port decides it over the
same tiles (fused.handoff_valid over tile consecutive batch positions).
The port is held to the JAX kernel built at tile = 1 on the first 8 start
roots and on tests/test_torch_tracker.py's end window, and at tile = 32
(the end window as one tile) on that window, where the JAX kernel ends
some flag-stable path otherwise than at tile 1.  A unit test holds the
tile rule to hand-made masks: tiles, a partial last tile, the one-call
tracker's pad (an active copy of path 0 in the last tile, as the JAX
package's one launch pads) against the segmented tracker's pruned pads,
and the reset at a call's start; another the elimination a tile keeps
(the tile's last full corrector iteration's, refactored at its final
point for a path that stopped before it) on hand-made iteration counts.
The
rule is that file's, with one exemption, proved per path: a flag-stable
path whose flags differ is dropped from the comparison only if some system
it solves in the window has a float64 condition number above 2^24, where
a float32 solve keeps no correct digit and the step's outcome is the
rounding's.  In the end window that is one path (its handoff system has a
condition number of about 6e9, and the JAX kernel's replay rolls its step
back where the port's advances; the port's outcome there is unmoved by
1e-7, 1e-6 and 1e-5 perturbations of its input and by its other solve
program).

The kept elimination lives only for a call (the kernel keeps it in shared
memory for a launch), as the JAX kernel resets its handoff flag at every
launch: so a segmented run equals track_plain called once per segment, and
no longer one call over the budget.  Then a CPU engine round at H = 1
under CPH against that segmented track_plain.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_tracker as ttt
from test_torch_tracker import _few_threads, end_window, setup  # noqa: F401
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    fused,
    segmented,
)

_CPH = dict(predictor_handoff=True, tile=1)   # the per-path decision
_START_PATHS = 8
_SINGULAR = 2.0 ** 24   # 1 / float32's unit roundoff


@pytest.fixture(scope="module")
def cph(setup):  # noqa: F811
    return ttt._variant_setup(setup, 1, **_CPH)


def test_start_window_matches_jax_kernel(cph):
    cfg, port, _, c, _, tgt_all = cph
    x = np.ascontiguousarray(
        np.asarray(port.start_sols)[:_START_PATHS][:, c.perm])
    flags = fused.init_flags(cfg.hc, _START_PATHS).numpy()
    stable, calm, (_, _, _, steps) = ttt._compare_window(
        cph, x, x, flags, tgt_all[:_START_PATHS])
    assert calm.all()
    assert int(steps.max()) == ttt._STEPS


def _singular_in_window(cph, x, xl, fl, tgt, monkeypatch):
    """excuse(i): whether path i, run alone through the window, factors a
    system whose float64 condition number exceeds _SINGULAR."""
    cfg, port, _, c, _, _ = cph
    factor = fused.factor_plain

    def excuse(i):
        systems = []

        def recording(tb, m):
            systems.append(torch.complex(m[0], m[1])[:, :, :c.n].numpy())
            return factor(tb, m)

        monkeypatch.setattr(fused, "factor_plain", recording)
        try:
            fused.track_plain(
                c, cfg.hc, torch.as_tensor(x[i:i + 1]),
                torch.as_tensor(xl[i:i + 1]), torch.as_tensor(fl[i:i + 1]),
                fused.build_pair_coefs(port, torch.as_tensor(tgt[i:i + 1]),
                                       cfg.hc.pair_coef_basis),
                niter=ttt._STEPS)
        finally:
            monkeypatch.setattr(fused, "factor_plain", factor)
        cond = max(np.linalg.cond(a.astype(np.complex128)).max()
                   for a in systems)
        return bool(cond > _SINGULAR)

    return excuse


@pytest.fixture(scope="module")
def cph_whole_tile(setup):  # noqa: F811
    """The JAX kernel and the port under CPH at a tile of the window's 32
    paths."""
    return ttt._variant_setup(setup, ttt._TR, predictor_handoff=True,
                              tile=ttt._TR)


def test_handoff_is_decided_per_tile(cph, cph_whole_tile, end_window,  # noqa: F811
                                     monkeypatch):
    """The end window at tile 32 is one tile, so a path's stage 1 replays
    only after a step in which no path of the 32 rolled back: some
    flag-stable path then ends its window with other flags than at tile
    1, whose flags the port's at tile 1 match (the window rule)."""
    x, xl, fl, tgt = end_window
    stable, _, _ = ttt._compare_window(
        cph, x, xl, fl, tgt,
        excuse=_singular_in_window(cph, x, xl, fl, tgt, monkeypatch))
    _, _, one = ttt._jax_steps(cph, x, xl, fl, tgt, ttt._STEPS)
    _, _, whole = ttt._jax_steps(cph_whole_tile, x, xl, fl, tgt, ttt._STEPS)
    moved = stable & (one != whole).any(axis=1)
    assert moved.any()


def test_end_window_matches_jax_kernel(cph, end_window, monkeypatch):  # noqa: F811
    x, xl, fl, tgt = end_window
    singular = _singular_in_window(cph, x, xl, fl, tgt, monkeypatch)
    dropped = []

    def excuse(i):
        dropped.append(i)
        return singular(i)

    stable, calm, (conv, inf, prn, _) = ttt._compare_window(
        cph, x, xl, fl, tgt, excuse=excuse)
    assert len(dropped) <= 1
    conv, inf, prn = (a.numpy() & stable for a in (conv, inf, prn))
    assert conv.sum() >= 2 and inf.sum() >= 1 and prn.sum() >= 5
    assert stable.sum() >= 0.75 * ttt._TR and calm.sum() >= 0.5 * ttt._TR


def test_end_window_matches_jax_kernel_at_tile_32(cph_whole_tile,
                                                  end_window,  # noqa: F811
                                                  monkeypatch):
    """The port's track_plain at tile 32 against the JAX kernel at tile 32
    on the end window (one tile), by the window rule with its exemption,
    and one more, on the JAX side: the JAX kernel computes every lane of
    a tile at every step, finished or not, and masks the result by 0/1
    arithmetic, so a lane whose stale kept elimination replays to a NaN
    gets that NaN written into its x (0 x NaN) although it took no step,
    and its depth-check flag then reads the NaN.  A path whose step count
    did not move in the window, from a finite x to a non-finite one in the
    JAX kernel, is such a lane and is dropped; the port keeps a finished
    path's state final."""
    x, xl, fl, tgt = end_window
    singular = _singular_in_window(cph_whole_tile, x, xl, fl, tgt,
                                   monkeypatch)
    rx, _, rfl = ttt._jax_steps(cph_whole_tile, x, xl, fl, tgt, ttt._STEPS)
    nst = fused._F_NST
    written, dropped = [], []

    def excuse(i):
        if (rfl[i, nst] == fl[i, nst] and np.isfinite(x[i]).all()
                and not np.isfinite(rx[i]).all()):
            written.append(i)
            return True
        dropped.append(i)
        return singular(i)

    stable, calm, (conv, inf, prn, _) = ttt._compare_window(
        cph_whole_tile, x, xl, fl, tgt, excuse=excuse)
    assert len(dropped) <= 1 and len(written) <= 2
    conv, inf, prn = (a.numpy() & stable for a in (conv, inf, prn))
    assert conv.sum() >= 2 and inf.sum() >= 1 and prn.sum() >= 5
    assert stable.sum() >= 0.75 * ttt._TR and calm.sum() >= 0.5 * ttt._TR


def test_tile_rule_on_hand_made_masks(setup):  # noqa: F811
    """fused.handoff_valid: a path's handoff holds after a step in which
    no path of its tile (tile consecutive batch positions) rolled back.
    Several tiles and a partial last one; the one-call tracker's pad (an
    active copy of path 0 in the last tile, as the JAX package's one
    launch pads) against the segmented tracker's none (its pads are
    pruned there); and the reset at a call's start (no replay at its first
    step)."""
    T, F = True, False
    fail = torch.zeros(10, dtype=torch.bool)
    fail[5] = True
    assert fused.handoff_valid(fail, 4).tolist() == [T] * 4 + [F] * 4 + [T] * 2
    assert torch.equal(fused.handoff_valid(fail, 1), ~fail)
    assert fused.handoff_valid(fail, 16).tolist() == [F] * 10
    last = torch.zeros(10, dtype=torch.bool)
    last[9] = True
    assert fused.handoff_valid(last, 4).tolist() == [T] * 8 + [F] * 2
    assert fused.handoff_valid(last, 5).tolist() == [T] * 5 + [F] * 5

    cfg = setup[0]
    hc = dataclasses.replace(cfg.hc, predictor_handoff=True, tile=4)
    assert fused.handoff_pad(hc, 10) == 1 and fused.handoff_pad(hc, 12) == 0
    assert fused.handoff_pad(dataclasses.replace(hc, tile=1), 10) == 0
    assert fused.handoff_pad(cfg.hc, 10) == 0   # no handoff
    first = torch.zeros(10, dtype=torch.bool)
    first[0] = True
    one_launch = fused.handoff_valid(torch.cat([first, first[:1]]), 4)[:10]
    assert one_launch.tolist() == [F] * 4 + [T] * 4 + [F] * 2
    assert fused.handoff_valid(first, 4).tolist() == [F] * 4 + [T] * 6

    # The trackers: the one-call tracker steps the pad too; no call
    # replays at its first step, so one step per call never replays.
    _, port, _, _, _, tgt_all = setup
    x0 = torch.as_tensor(np.asarray(port.start_sols)[:6])
    tgt = torch.as_tensor(tgt_all[:6])
    for steps, pad in ((1, 1), (2, 1)):
        work = {}
        fused.make_plain_track_fn(port, dataclasses.replace(
            hc, max_steps=steps - 1))(x0, tgt, work=work)
        assert work["steps"] == steps * (6 + pad)
        assert (work.get("replays", 0) > 0) == (steps > 1)
    work = {}
    segmented.make_segmented_track_fn(port, dataclasses.replace(
        hc, max_steps=1, segment_steps=1), plain=True)(x0, tgt, work=work)
    assert work["steps"] == 2 * 6 and work.get("replays", 0) == 0


@pytest.mark.parametrize("cjr", [0, 1, 2])
def test_refactor_rule_on_hand_made_counts(setup, cjr):  # noqa: F811
    """fused.handoff_refactor: a path is factored again at its final point
    when its corrector stopped before its tile's last full iteration (the
    tile's most iterations m, no later than the cjr-th under
    corrector_jacobian_reuse); a path that took no step (0) never is, and
    nothing is at tile 1."""
    hc = dataclasses.replace(setup[0].hc, predictor_handoff=True, tile=4,
                             corrector_jacobian_reuse=cjr)
    assert hc.max_correction_steps == 3
    its = torch.tensor([1, 2, 1, 1, 0, 1, 1, 1, 3, 2], dtype=torch.int32)
    k = {0: 3, 1: 1, 2: 2}[cjr]   # the last iteration that factors
    # The tiles' most iterations are 2, 1 and 3 (a partial last tile).
    want = ([0 < int(c) < min(2, k) for c in its[:4]] + [False] * 4
            + [0 < int(c) < min(3, k) for c in its[8:]])
    assert fused.handoff_refactor(its, hc).tolist() == want
    assert not fused.handoff_refactor(
        its, dataclasses.replace(hc, tile=1)).any()
    assert fused.handoff_refactor(
        its, dataclasses.replace(hc, tile=16)).tolist() == [
            0 < int(c) < min(3, k) for c in its]


def _track_plain_by_segments(problem, hc, x0, tgt):
    """track_plain called once per segment of hc.segment_steps steps on
    the carried state, as TrackResult."""
    c = fused.FusedConstants.build(problem, solver=fused.solver_of(hc))
    perm = torch.as_tensor(c.perm, dtype=torch.long)
    x = x0[:, perm].contiguous()
    xl, fl = x.clone(), fused.init_flags(hc, x.shape[0])
    efg = fused.build_pair_coefs(problem, tgt, hc.pair_coef_basis)
    budget = hc.max_steps + 1
    for lo in range(0, budget, hc.segment_steps):
        x, xl, fl = fused.track_plain(
            c, hc, x, xl, fl, efg, niter=min(hc.segment_steps, budget - lo))
    conv, inf, pruned, steps = fused.flags_outputs(hc, fl)
    return fused.TrackResult(x=x[:, torch.argsort(perm)], converged=conv,
                             inf_fail=inf, pruned=pruned, num_steps=steps)


def test_segmented_handoff_restarts_at_every_segment(setup):  # noqa: F811
    """Two segments of 3 steps (with packing) on 32 paths equal track_plain
    called twice with that split, bit for bit, and differ from one call of
    6 steps: each segment's first step solves stage 1 in full."""
    cfg, port, _, _, _, tgt_all = setup
    hc = dataclasses.replace(cfg.hc, max_steps=5, segment_steps=3, **_CPH)
    x0 = torch.as_tensor(np.asarray(port.start_sols)[:ttt._TR])
    tgt = torch.as_tensor(tgt_all[:ttt._TR])
    work = {}
    seg = segmented.make_segmented_track_fn(port, hc, plain=True)(
        x0, tgt, work=work).track
    two = _track_plain_by_segments(port, hc, x0, tgt)
    one = fused.make_plain_track_fn(port, hc)(x0, tgt)
    for f in ("x", "converged", "inf_fail", "pruned", "num_steps"):
        assert torch.equal(getattr(seg, f), getattr(two, f)), f
    assert int(seg.num_steps.max()) == 6
    assert not torch.equal(seg.x, one.x)
    # The plain segmented tracker (the kernel's reference on the card)
    # counts the handoff's replays: none at a segment's first step.
    assert work["steps"] == int(seg.num_steps.sum())
    assert 0 < work["replays"] <= work["steps"] - 2 * ttt._TR


def test_engine_round_runs_the_variant(setup):  # noqa: F811
    ttt._engine_round_matches_track_plain(setup[0], _CPH,
                                          _track_plain_by_segments)
