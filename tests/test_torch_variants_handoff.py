"""The corrector -> predictor handoff (predictor_handoff, CPH) against the
JAX package: RK stage 1 replays the previous step's last full corrector
elimination on the fresh -Ht, where that step did not roll back.

The JAX kernel decides the handoff per tile (every lane of the tile
advanced); the port's counterpart of a tile is one path, so it decides
per path.  That is the JAX kernel's own function at tile = 1 only, so
check_shipped refuses the handoff at any other HCConfig.tile, every
configuration here sets tile = 1, and the JAX kernel is built at tile = 1:
on the first 8 start roots, and on tests/test_torch_tracker.py's end
window.  At a tile of 32 (the end window as one tile) the JAX kernel ends
some flag-stable path otherwise than at tile 1, where the port agrees with
tile 1: the refusal's reason, shown.  The
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

_CPH = dict(predictor_handoff=True, tile=1)
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
    """The JAX kernel under CPH at a tile of the window's 32 paths."""
    return ttt._variant_setup(setup, ttt._TR, **_CPH)


def test_handoff_is_decided_per_tile(cph, cph_whole_tile, end_window,  # noqa: F811
                                     monkeypatch):
    """The end window at tile 32 is one tile, so a path's stage 1 replays
    only after a step in which no path of the 32 rolled back: some
    flag-stable path then ends its window with other flags than at tile
    1, whose flags the port's match (the window rule)."""
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
