"""The segment loop (ops/segmented.py) and the abort round, on the CPU.

* Segmented tracking equals one call over the whole budget, path for path
  and bit for bit (flags, step counts, x), with survivor compaction on and
  off: the first 32 roots of hypothesis 0 (view 0, seed 0).
* The compaction order and the scoring slots against numpy's and JAX's
  stable argsort of the same keys; ``_score_new`` (imaginary gate,
  Cayley -> R, inlier counts, pass test, running best, slot overflow)
  against the JAX package's Cayley and support functions on seeded states.
* The abort plumbing with the gates relaxed as tests/test_parallel.py
  relaxes them (pass ratio 0, imaginary tolerance 1e9) and hypothesis 0's
  target set to the start parameters, so that its paths converge at once:
  the tracker stops at the first segment boundary with ``found`` set, and
  the engine's abort round with ``abort_chunk=1`` runs one chunk of two.
* In the slow tier: that round against the JAX engine's, its Pallas kernel
  in interpret mode.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_tpu import engine as jengine
from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
    trifocal as jtrifocal,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import (
    ransac as jransac,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch import engine
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    fused,
    ransac,
    segmented,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import config
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import data_io

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")
_TR = 32
_SUP_FRAC = 0.002   # the reference's support band (cli.py _CC_SUP_FRAC)


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
    port = trifocal.TrifocalProblem.load(cfg)
    d = config.ransac_data_dir(cfg)
    view = data_io.load_ransac_view(d, 0)
    kmat = data_io.load_intrinsic_matrix(d)
    samples = ransac.sample_edgel_triplets(0, view.edge_locations.shape[0], 2)
    tgt = ransac.build_target_params(view.edge_locations, view.edge_tangents,
                                     samples)
    return cfg, port, view, kmat, tgt


def _bits(x):
    return torch.view_as_real(x).view(torch.int32)


@pytest.mark.parametrize("compact", [True, False])
def test_segmented_equals_one_call(setup, compact):
    cfg, port, _, _, tgt = setup
    hc = dataclasses.replace(cfg.hc, compact_survivors=compact)
    x0 = torch.as_tensor(port.start_sols[:_TR])
    tg = torch.as_tensor(np.repeat(tgt[:1], _TR, axis=0))
    one = fused.make_track_fn(port, hc)(x0, tg)
    seg = segmented.make_segmented_track_fn(port, hc)(x0, tg)
    assert not seg.found and seg.best_support == -1
    for f in ("converged", "inf_fail", "pruned", "num_steps"):
        assert torch.equal(getattr(seg.track, f), getattr(one, f)), f
    assert torch.equal(_bits(seg.track.x), _bits(one.x))
    # More than one segment ran, and paths ended in different segments.
    steps = one.num_steps
    assert int(steps.max()) > hc.segment_steps
    assert len(set((steps - 1).div(hc.segment_steps,
                                   rounding_mode="floor").tolist())) >= 2


def _seeded_flags(rng, hc, n):
    """Flags (n, 8) with converged, near-converged, diverged and pruned
    paths, and ties in t."""
    fl = fused.init_flags(hc, n).numpy()
    t = rng.choice(np.float32([0.0, 0.25, 0.5, 0.75, 0.99, 1.0 - 5e-8, 1.0]),
                   size=n)
    fl[:, fused._F_T] = t
    fl[:, fused._F_INF] = rng.random(n) < 0.1
    fl[:, fused._F_PRN] = rng.random(n) < 0.1
    return fl


def test_compaction_order_matches_stable_argsort(setup):
    cfg = setup[0]
    hc = cfg.hc
    fl = _seeded_flags(np.random.default_rng(0), hc, 500)
    t = fl[:, fused._F_T]
    conv = (t >= 1.0) | (np.float32(1.0) - t <= hc.t_converged_eps)
    active = ~conv & (fl[:, fused._F_INF] < 0.5) & (fl[:, fused._F_PRN] < 0.5)
    key = np.where(active, np.float32(1.0) - t, np.float32(2.0))
    got = segmented.compaction_order(hc, torch.as_tensor(fl)).numpy()
    np.testing.assert_array_equal(got, np.argsort(key, kind="stable"))
    np.testing.assert_array_equal(
        got, np.asarray(jnp.argsort(jnp.asarray(key), stable=True)))
    np.testing.assert_array_equal(
        segmented.active_mask(hc, torch.as_tensor(fl)).numpy(), active)


def _cayley_params(r):
    """The Cayley vector of rotation r (the inverse of cayley_to_rotation)."""
    return np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0],
                     r[1, 0] - r[0, 1]]) / (1.0 + np.trace(r))


@pytest.fixture(scope="module")
def scoring(setup):
    """A segmented run with scoring on, and a seeded state of 300 paths:
    pose components at the ground truth (some nudged off it, some with
    large imaginary parts) or random, mixed flags, some paths already
    scored, a random packing order."""
    cfg, port, view, kmat, tgt = setup
    track = segmented.make_segmented_track_fn(
        port, cfg.hc, dataclasses.replace(cfg.ransac, abort_by_good_sol=True))
    n = 300
    rng = np.random.default_rng(1)
    x0 = torch.as_tensor(np.resize(port.start_sols, (n, 30)))
    tg = torch.as_tensor(np.repeat(tgt[:1], n, axis=0))
    run = track.begin(x0, tg, torch.as_tensor(view.edge_locations),
                      torch.as_tensor(kmat), view.edge_locations.shape[0])
    gt = np.concatenate([view.gt_pose21[:, 3], view.gt_pose31[:, 3],
                         _cayley_params(view.gt_pose21[:, :3]),
                         _cayley_params(view.gt_pose31[:, :3])])
    pose = np.where(rng.random((n, 1)) < 0.6,
                    gt * (1 + rng.choice([0.0, 1e-4, 1e-2], size=(n, 1))
                          * rng.standard_normal((n, 12))),
                    rng.standard_normal((n, 12)))
    imag = rng.choice([1e-7, 1e-3], p=[0.8, 0.2], size=(n, 1)) * \
        rng.standard_normal((n, 12))
    x = (rng.standard_normal((n, 30)) + 1j * rng.standard_normal((n, 30)))
    rows = run.pose_rows.numpy()
    x[:, rows] = pose + 1j * imag
    fl = _seeded_flags(rng, cfg.hc, n)
    fl[:, fused._F_T] = np.where(rng.random(n) < 0.7, 1.0,
                                 fl[:, fused._F_T])
    run.x = torch.as_tensor(x.astype(np.complex64))
    run.fl = torch.as_tensor(fl)
    run.scored = torch.as_tensor(rng.random(n) < 0.2)
    run.order = torch.as_tensor(rng.permutation(n))
    return cfg, view, kmat, run


def _score_reference(cfg, view, kmat, x, fl, scored, order, best):
    """The JAX package's _score_new on the same state: the gate and counts
    by its functions, the slots by a stable argsort."""
    rc = cfg.ransac
    t = fl[:, fused._F_T]
    newly = ((t >= 1.0) | (np.float32(1.0) - t <= cfg.hc.t_converged_eps)) \
        & ~scored
    sidx = np.argsort(~newly, kind="stable")[:segmented._SCORE_SLOTS]
    valid = newly[sidx]
    scored = scored.copy()
    scored[sidx] |= valid
    pv = x[sidx][:, [18 + i for i in range(12)]]
    gate = np.abs(pv.imag).max(axis=1) < rc.imag_part_tol
    pr = jnp.asarray(pv.real, jnp.float32)
    n21, n31 = (np.asarray(a) for a in jransac.count_inlier_support(
        jtrifocal.cayley_to_rotation(pr[:, 6:9]),
        jtrifocal.cayley_to_rotation(pr[:, 9:12]), pr[:, 0:3], pr[:, 3:6],
        jnp.asarray(view.edge_locations), jnp.asarray(kmat, jnp.float32),
        thresh_px=rc.reproj_inlier_thresh_px))
    need = np.float32(rc.pass_inlier_support_ratio) * np.float32(
        view.edge_locations.shape[0])
    hit = valid & gate & (n21 >= need) & (n31 >= need)
    found_path = int(order[sidx[np.argmax(hit)]]) if hit.any() else -1
    smin = np.where(valid & gate, np.minimum(n21, n31), -1)
    sb = int(np.argmax(smin))
    if smin[sb] > best[0]:
        best = (int(smin[sb]), int(order[sidx[sb]]))
    return scored, found_path, best, n21, n31, sidx


def test_score_new_matches_reference(scoring):
    cfg, view, kmat, run = scoring
    inv = torch.argsort(torch.as_tensor(run.tr.consts.perm))
    x_var = run.x[:, inv].numpy()   # variable order, as the reference reads
    fl, order = run.fl.numpy(), run.order.numpy()
    scored = run.scored.numpy()
    best = (-1, -1)
    conv = fused.flags_outputs(cfg.hc, run.fl)[0].numpy()
    assert conv[~scored].sum() > segmented._SCORE_SLOTS   # the slots overflow
    found_paths = []
    for _ in range(2):
        sidx, _ = segmented.score_slots(cfg.hc, run.fl, run.scored)
        scored, fp, best, n21, n31, ref_sidx = _score_reference(
            cfg, view, kmat, x_var, fl, scored, order, best)
        np.testing.assert_array_equal(sidx.numpy(), ref_sidx)
        run._score_new()
        np.testing.assert_array_equal(run.scored.numpy(), scored)
        found_paths.append(fp)
        assert (int(run.best_supp), int(run.best_path)) == best
    # The overflow was scored at the second call, none dropped: every
    # converged path is now scored.
    assert conv[~scored].sum() == 0
    # The state has passing poses; the first found path is kept.
    assert found_paths[0] >= 0
    assert bool(run.found) and int(run.found_path) == found_paths[0]
    assert best[0] >= 0.9 * view.edge_locations.shape[0]


def _relaxed_ransac(cfg, **kw):
    """Any converged path passes: isolates the abort plumbing."""
    return dataclasses.replace(cfg.ransac, abort_by_good_sol=True,
                               pass_inlier_support_ratio=0.0,
                               imag_part_tol=1e9, **kw)


def test_abort_stops_at_first_boundary(setup):
    """Hypothesis 0 (target = start, so its paths converge in 3 steps with
    init_delta_t 0.5 and no pruning, as in tests/test_parallel.py) beside
    hypothesis 1 (a real target): the tracker stops at the first boundary
    (4 steps), with a converged path of hypothesis 0 as the found path."""
    cfg, port, view, kmat, tgt = setup
    hc = dataclasses.replace(cfg.hc, segment_steps=4, init_delta_t=0.5,
                             truncate_paths=False)
    half = _TR // 2
    tg = np.repeat(tgt[:2], half, axis=0)
    tg[:half] = port.start_params
    x0 = torch.as_tensor(np.concatenate([port.start_sols[:half]] * 2))
    track = segmented.make_segmented_track_fn(port, hc, _relaxed_ransac(cfg))
    res = track(x0, torch.as_tensor(tg), torch.as_tensor(view.edge_locations),
                torch.as_tensor(kmat))
    assert res.found
    assert 0 <= res.found_path < half
    assert bool(res.track.converged[res.found_path])
    assert res.best_support >= 0 and 0 <= res.best_path < half
    assert int(res.track.num_steps.max()) == hc.segment_steps
    assert not bool(res.track.converged[half:].any())


def _start_target_round(monkeypatch, jax_too=False):
    """Make every round's hypothesis 0 target its start parameters."""
    def patch(module, start):
        build = module.build_target_params

        def build_target_params(*args):
            tgt = build(*args)
            tgt[0] = start
            return tgt

        monkeypatch.setattr(module, "build_target_params", build_target_params)

    cfg = config.EngineConfig(data_root=DATA)
    start = trifocal.TrifocalProblem.load(cfg).start_params
    patch(ransac, start)
    if jax_too:
        patch(jransac, start)
    return dataclasses.replace(cfg, ransac=_relaxed_ransac(cfg, abort_chunk=1))


def test_engine_abort_round_stops_after_first_chunk(monkeypatch):
    """H = 2, abort_chunk = 1: hypothesis 0's unpruned paths converge at
    step 21, so chunk 0 finds at its third boundary and chunk 1 never
    starts."""
    cfg = _start_target_round(monkeypatch)
    port = engine.TrifocalPoseEngine(cfg, device="cpu")
    view = port.load_view(0)
    rr = port.run_round(view, seed=0, num_hypotheses=2)
    T = port.problem.num_tracks
    assert rr.chunks_run == 1
    assert rr.found_pose and rr.num_candidates >= 1
    assert rr.converged[:T].any() and int(rr.num_steps[:T].max()) <= 24
    # The chunk never run counts as having no candidates.
    assert not rr.converged[T:].any() and not rr.num_steps[T:].any()
    assert rr.num_steps.shape == (2 * T,)
    assert rr.track_ms > 0 and rr.total_ms >= rr.track_ms


@pytest.mark.slow
def test_engine_abort_round_matches_jax_engine(monkeypatch):
    """The same round through the JAX engine, its segmented Pallas kernel
    in interpret mode: the same chunks run, the same found_pose, and the
    best supports within the reference's band."""
    cfg = _start_target_round(monkeypatch, jax_too=True)
    port = engine.TrifocalPoseEngine(cfg, device="cpu")
    view = port.load_view(0)
    rr = port.run_round(view, seed=0, num_hypotheses=2)
    monkeypatch.setenv("TPUHC_FORCE_INTERPRET", "1")
    jcfg = dataclasses.replace(cfg, problem=config.problem_config(cfg))
    rj = jengine.TrifocalPoseEngine(jcfg).run_round(view, seed=0,
                                                    num_hypotheses=2)
    T = port.problem.num_tracks
    # The JAX result has no chunk count: a chunk that ran has step counts.
    ran = np.asarray(rj.num_steps).reshape(2, T).any(axis=1)
    assert int(ran.sum()) == rr.chunks_run and ran[0]
    assert rj.found_pose == rr.found_pose
    tol = max(5, int(_SUP_FRAC * view.edge_locations.shape[0]))
    assert abs(rr.best_support21 - rj.best_support21) <= tol
    assert abs(rr.best_support31 - rj.best_support31) <= tol
