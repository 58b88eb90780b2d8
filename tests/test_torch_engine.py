"""The port's RANSAC round against the JAX engine's, both on the CPU.

View 0, seed 0, H = 2 hypotheses (2 x the problem's roots paths).
Sampling and target construction must be bit-equal.

The JAX engine's CPU backend tracks with its full-pivot XLA oracle, the
port with the kernel's restricted pivoting.  On the committed problem
many path endings are close to singular, so two float32 trackers that
differ only in rounding end some paths differently.  The JAX package's
own two trackers (its Pallas kernel in interpret mode and its XLA oracle)
disagree on 10 converged, 3 inf and 8 pruned flags of these 614 paths,
1.6 % at most, and a 1e-7 relative perturbation of the port's start roots
flips 8 converged and 10 pruned flags of its own.  So the reference's
cross-check band (cli.py _CC_FLIP_FRAC, 0.5 %, measured on its own
problem) does not hold here; per-path flags and the converged count may
differ by 3.2 % of paths (twice the JAX package's own disagreement), and
the best supports by 0.2 % of the edgels (floor 5), the reference's
_CC_SUP_FRAC.  tests/test_torch_tracker.py holds the tracker to the JAX
kernel step by step.

The port's oracle round (``backend="xla"``, ops/tracker.py) on the same
inputs is held to the JAX round, which is the JAX oracle's: they are two
float32 implementations of one tracker, and on these 614 paths they
disagree on 9 converged, 5 inf and 11 pruned flags (1.8 % at most,
measured); the same 3.2 % band applies, and the supports within 0.2 %.
As in the JAX engine, the oracle round with the TrunRANSAC abort flag
tracks every hypothesis (the abort needs the segmented tracker).

The port's round collects its solutions (``collect_solutions=True``), as
the JAX round does.  The port's ``_score_round`` is also held to the JAX
engine's on the JAX round's own solutions, both as a collecting and as a
default round scores: the same candidates, found flag, actual-solution
steps and per-path flags and steps, the best supports within the band
above; and, collecting, the same any-within-tolerance flag, and the
candidates' fundamental matrices and the residual minima within 1e-5
relative.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_tpu import engine as jengine
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import (
    ransac as jransac,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch import engine
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    fused,
    ransac,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import config

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")
_H = 2
_FLIP_FRAC = 0.032


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
def rounds():
    cfg = config.EngineConfig(data_root=DATA)
    port = engine.TrifocalPoseEngine(cfg, device="cpu")
    view = port.load_view(0)
    rr = port.run_round(view, seed=0, num_hypotheses=_H,
                        collect_solutions=True)
    jcfg = dataclasses.replace(cfg, problem=config.problem_config(cfg))
    ref = jengine.TrifocalPoseEngine(jcfg)
    rj = ref.run_round(view, seed=0, num_hypotheses=_H,
                       collect_solutions=True)
    return view, rr, rj, _H * port.problem.num_tracks


@pytest.fixture(scope="module")
def xla_round(rounds):
    view, _, rj, n_paths = rounds
    cfg = config.EngineConfig(data_root=DATA, hc=config.HCConfig(
        backend="xla"))
    port = engine.TrifocalPoseEngine(cfg, device="cpu")
    rx = port.run_round(view, seed=0, num_hypotheses=_H,
                        collect_solutions=True)
    return view, rx, rj, n_paths


def test_sampling_and_targets_bit_equal():
    cfg = config.EngineConfig(data_root=DATA)
    view = engine.TrifocalPoseEngine(cfg, device="cpu").load_view(0)
    n = view.edge_locations.shape[0]
    s = ransac.sample_edgel_triplets(0, n, 100)
    assert np.array_equal(s, jransac.sample_edgel_triplets(0, n, 100))
    t = ransac.build_target_params(view.edge_locations, view.edge_tangents, s)
    tj = jransac.build_target_params(view.edge_locations, view.edge_tangents, s)
    assert t.dtype == tj.dtype and np.array_equal(t, tj)


def test_engine_runs_on_the_card_by_default(monkeypatch):
    """No device means cuda:0; without a card that raises and never falls
    back to the CPU."""
    cfg = config.EngineConfig(data_root=DATA)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.TrifocalPoseEngine(cfg)
    assert engine.TrifocalPoseEngine(cfg, device="cpu").device.type == "cpu"


def test_xla_engine_runs_on_the_card_by_default(monkeypatch):
    """The oracle engine too: no device means cuda:0, which raises without
    a card, and the CPU only when asked for."""
    cfg = config.EngineConfig(data_root=DATA, hc=config.HCConfig(
        backend="xla"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.TrifocalPoseEngine(cfg)
    e = engine.TrifocalPoseEngine(cfg, device="cpu")
    assert e.device.type == "cpu" and not e._segmented


@pytest.mark.parametrize("flag", ["converged", "inf_fail", "pruned"])
def test_xla_round_flags_within_band(xla_round, flag):
    _, rx, rj, n_paths = xla_round
    a = rx.solutions
    b = rj.solutions
    assert getattr(a, flag).shape == (n_paths,)
    assert int((getattr(a, flag) != np.asarray(getattr(b, flag))).sum()) \
        <= int(_FLIP_FRAC * n_paths)


def test_xla_round_supports_within_band(xla_round):
    view, rx, rj, n_paths = xla_round
    tol = max(5, int(0.002 * view.edge_locations.shape[0]))
    assert abs(rx.best_support21 - rj.best_support21) <= tol
    assert abs(rx.best_support31 - rj.best_support31) <= tol
    assert abs(rx.stats.num_converged - rj.stats.num_converged) <= int(
        _FLIP_FRAC * n_paths)
    assert rx.solutions.x.dtype == np.complex64


def test_xla_round_with_abort_tracks_every_hypothesis(rounds):
    """The abort flag does not chunk the oracle's round (a short budget of
    6 steps; 3 hypotheses, which the abort would track in chunks of 1)."""
    view = rounds[0]
    cfg = config.EngineConfig(
        data_root=DATA,
        hc=config.HCConfig(backend="xla", max_steps=6),
        ransac=config.RansacConfig(abort_by_good_sol=True, abort_chunk=1))
    port = engine.TrifocalPoseEngine(cfg, device="cpu")
    assert not port._abort and not port._segmented
    rr = port.run_round(view, seed=0, num_hypotheses=3)
    T = port.problem.num_tracks
    assert rr.chunks_run == 1 and rr.stats.num_paths == 3 * T
    # Every hypothesis's paths were tracked (a skipped chunk's paths would
    # have taken no step).
    assert (rr.num_steps.reshape(3, T) > 0).all()


@pytest.mark.parametrize("flag", ["converged", "inf_fail", "pruned"])
def test_round_flags_within_band(rounds, flag):
    _, rr, rj, n_paths = rounds
    a = getattr(rr, flag)
    b = np.asarray(getattr(rj.solutions, flag))
    assert a.shape == b.shape == (n_paths,)
    assert int((a != b).sum()) <= int(_FLIP_FRAC * a.size)


def test_round_supports_within_band(rounds):
    view, rr, rj, n_paths = rounds
    tol = max(5, int(0.002 * view.edge_locations.shape[0]))
    assert abs(rr.best_support21 - rj.best_support21) <= tol
    assert abs(rr.best_support31 - rj.best_support31) <= tol
    assert abs(rr.stats.num_converged - rj.stats.num_converged) <= int(
        _FLIP_FRAC * n_paths)
    assert rr.num_edgels == rj.num_edgels


def test_round_outputs_well_formed(rounds):
    view, rr, _, n_paths = rounds
    assert rr.num_steps.shape == (n_paths,)
    assert rr.num_steps.max() <= 81
    assert rr.stats.num_paths == n_paths
    assert rr.track_ms > 0 and rr.total_ms >= rr.track_ms
    if rr.num_candidates:
        assert rr.pose_errors is not None
        for m in rr.best_pose:
            assert np.isfinite(m).all()


def test_round_collects_its_solutions(rounds):
    """The collecting round's solutions are its per-path outcomes on the
    host, and its candidate fields have the candidates' length."""
    _, rr, _, n_paths = rounds
    sols = rr.solutions
    assert sols.x.shape == (n_paths, 30) and sols.x.dtype == np.complex64
    for f in ("converged", "inf_fail", "pruned", "num_steps"):
        assert np.array_equal(getattr(sols, f), getattr(rr, f)), f
    assert rr.cand_f21.shape == rr.cand_f31.shape == (rr.num_candidates, 3, 3)
    assert np.isfinite(rr.cand_f21).all() and np.isfinite(rr.cand_f31).all()
    if rr.num_candidates:
        assert rr.min_residuals is not None
        for a, b in zip(dataclasses.astuple(rr.min_residuals),
                        dataclasses.astuple(rr.pose_errors)):
            assert a <= b


def _score_jax_solutions(rounds, collect):
    """The port's _score_round over the JAX round's own solutions."""
    view, _, rj, _ = rounds
    cfg = config.EngineConfig(data_root=DATA)
    port = engine.TrifocalPoseEngine(cfg, device="cpu")
    s = rj.solutions
    res = fused.TrackResult(**{
        f: torch.as_tensor(np.array(getattr(s, f)))
        for f in ("x", "converged", "inf_fail", "pruned", "num_steps")})
    return view, port._score_round(
        view, res, torch.as_tensor(view.edge_locations), collect), rj


@pytest.fixture(scope="module", params=[True, False],
                ids=["collecting", "default"])
def scored(rounds, request):
    """Scored as a collecting round and as a default round, which shares
    the scorer and skips the collecting fields."""
    return _score_jax_solutions(rounds, request.param)


@pytest.fixture(scope="module")
def scored_collecting(rounds):
    return _score_jax_solutions(rounds, True)


def test_score_round_matches_jax_exactly(scored):
    _, out, rj = scored
    assert out["num_candidates"] == rj.num_candidates > 0
    assert out["found_pose"] == rj.found_pose
    assert np.array_equal(out["actual_sol_steps"], rj.actual_sol_steps)
    assert (dataclasses.astuple(out["stats"])
            == dataclasses.astuple(rj.stats))
    for f in ("converged", "inf_fail", "pruned", "num_steps"):
        assert np.array_equal(out[f], np.asarray(getattr(rj.solutions, f))), f


def test_score_round_supports_within_band(scored):
    view, out, rj = scored
    tol = max(5, int(0.002 * view.edge_locations.shape[0]))
    assert abs(out["best_support21"] - rj.best_support21) <= tol
    assert abs(out["best_support31"] - rj.best_support31) <= tol


def test_score_round_matrices_and_residuals_close(scored_collecting):
    _, out, rj = scored_collecting
    for f in ("cand_f21", "cand_f31"):
        a, b = out[f], np.asarray(getattr(rj, f))
        assert a.shape == b.shape == (rj.num_candidates, 3, 3), f
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), f
    for a, b in zip(dataclasses.astuple(out["min_residuals"]),
                    dataclasses.astuple(rj.min_residuals)):
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)
    assert out["any_within_gt"] == rj.any_within_gt
