"""Hypothesis sharding (parallel/mesh.py and the sharded engine) on the CPU.

The mesh is an explicit list of CPU devices, the counterpart of the JAX
tests' virtual CPU devices (tests/conftest.py); a shard on the CPU runs
the kernel's plain twin (``fused.track_plain``) or the oracle.

* The sharded oracle on ``["cpu"] * 4`` against the JAX package's
  ``make_sharded_track_fn(backend="xla")`` on 4 of the conftest's 8
  virtual devices: view 0, sampling seed 3, 8 hypotheses x the first 16
  roots, ``max_steps=12``, the handoff off (tests/test_parallel.py's
  setup, on the generated data).  Two float32 oracles that round
  differently part on near-singular endings, so, as in
  tests/test_torch_oracle.py, flags and step counts must agree on the
  paths that four 1e-7 nudges of the port's inputs do not change (at
  least 75 % of them), and x within 1e-3 relative where both converge.
* The sharded segmented tracker and the sharded one-call tracker equal
  their unsharded trackers path for path and bit for bit, over 2 and 3
  shards (sharding only splits the batch).
* The cross-shard abort (the JAX ``test_cross_chip_abort_stops_other_devices``
  scenario): one shard's hypothesis targets the start parameters, the pass
  ratio is 0, the imaginary tolerance huge and TrunPaths off; its hit
  stops every other shard before its budget, and ``found_path`` is a global
  index in that shard.
* The loop test's exchange: with one shard's hypothesis targeting the
  start parameters, that shard has no active path after the first
  boundary while the others still have; the sound mesh tracks every path
  as one shard does, and a mesh that reads the finished shard's loop test
  alone stops the others short.
* The mesh's spans: one ``mesh.scatter`` and one ``mesh.gather`` a run, a
  ``mesh.advance`` (each shard's ``segment.launch`` and
  ``segment.boundary``, in shard order) and a ``mesh.keep`` (each shard's
  ``segment.wait``) a boundary; a round on one device records no
  ``mesh.*`` span.
* The engine's ``num_devices=4`` oracle round (H = 4) against the JAX
  engine's (``test_engine_multidevice_round``'s setup): converged and
  infinity counts within the 3.2 % band of tests/test_torch_engine.py,
  best supports within 0.2 % of the edgels (floor 5).
* Padding: H = 3 over 2 shards samples 4 hypotheses whose first 3 are the
  unpadded round's, tracks them and slices the fourth away (the round
  equals the unsharded one path for path), and the abort chunk rounds up
  to whole shards.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_tpu import engine as jengine
from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
    trifocal as jtrifocal,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.parallel import (
    mesh as jmesh,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch import engine
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    fused,
    ransac,
    segmented,
    tracker,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.parallel import (
    mesh as pmesh,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
    config,
    data_io,
    spans,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")
_PERTURBATIONS = 4
_FLAGS = ("converged", "inf_fail", "pruned", "num_steps")
_FLIP_FRAC = 0.032


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads (see tests/test_torch_engine.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    cfg = config.EngineConfig(data_root=DATA)
    problem = trifocal.TrifocalProblem.load(cfg)
    view = data_io.load_ransac_view(config.ransac_data_dir(cfg), 0)
    return cfg, problem, view


def _workload(setup, H, T, seed=3, trivial=()):
    """x0 (H*T, V), target (H*T, P+1), diff, as numpy: hypotheses of
    view 0 (sampling seed ``seed``) over the first T roots; the hypotheses
    ``trivial`` target the start parameters."""
    _, problem, view = setup
    s = ransac.sample_edgel_triplets(seed, view.edge_locations.shape[0], H)
    tgt = ransac.build_target_params(view.edge_locations, view.edge_tangents,
                                     s)
    tgt[list(trivial)] = problem.start_params
    tgt_b = np.repeat(tgt, T, axis=0)
    diff_b = (tgt_b - problem.start_params).astype(np.complex64)
    x0 = np.tile(np.asarray(problem.start_sols)[:T], (H, 1))
    return x0, tgt_b, diff_b


def _bits(x):
    return torch.view_as_real(x).view(torch.int32)


def _same(a, b):
    for f in _FLAGS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(_bits(a.x), _bits(b.x))


def test_make_mesh_explicit_and_refusals(monkeypatch):
    mesh = pmesh.make_mesh(4, ["cpu"] * 4)
    assert mesh == [torch.device("cpu")] * 4
    assert pmesh.make_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="2 devices given"):
        pmesh.make_mesh(3, ["cpu"] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="num_devices=2 > visible devices 1"):
        pmesh.make_mesh(2)


def test_sharded_oracle_matches_jax_mesh(setup):
    import jax

    cfg, problem, _ = setup
    assert len(jax.devices()) == 8
    hc = dataclasses.replace(cfg.hc, max_steps=12, predictor_handoff=False)
    H, T = 8, 16
    x0, tgt, diff = _workload(setup, H, T)
    jcfg = dataclasses.replace(cfg, problem=config.problem_config(cfg))
    jp = jtrifocal.TrifocalProblem.load(jcfg)
    jr = jmesh.make_sharded_track_fn(jp, hc, jmesh.make_mesh(4),
                                     backend="xla")(x0, tgt, diff)

    sharded = pmesh.make_sharded_track_fn(problem, hc, ["cpu"] * 4,
                                          backend="xla")
    base = sharded(torch.as_tensor(x0), torch.as_tensor(tgt))
    # Flag stability: four 1e-7 nudges of the inputs, through the port's
    # oracle in one batch (its paths are independent without the handoff).
    runs = []
    for seed in range(_PERTURBATIONS):
        rng = np.random.default_rng(seed)
        runs.append([(a * (1 + 1e-7 * rng.standard_normal(a.shape)))
                     .astype(a.dtype) for a in (x0, tgt, diff)])
    nudged = tracker.make_track_fn(problem, hc)(
        *(torch.as_tensor(np.concatenate(p)) for p in zip(*runs)))
    n = H * T
    stable = np.ones(n, bool)
    for f in _FLAGS:
        b = getattr(base, f).numpy()
        for i in range(_PERTURBATIONS):
            stable &= getattr(nudged, f).numpy()[i * n:(i + 1) * n] == b
    assert stable.sum() >= 0.75 * n, stable.sum()
    for f in _FLAGS:
        np.testing.assert_array_equal(getattr(base, f).numpy()[stable],
                                      np.asarray(getattr(jr, f))[stable], f)
    both = base.converged.numpy() & np.asarray(jr.converged)
    scale = np.maximum(np.abs(jr.x).max(axis=1), 1.0)
    err = np.abs(base.x.numpy() - jr.x).max(axis=1) / scale
    assert (err[both] < 1e-3).all(), err[both]


@pytest.fixture(scope="module")
def small(setup):
    """Six hypotheses over the first 8 roots, hypothesis 1 targeting the
    start parameters (its paths converge within the 13 steps), segments of
    4 steps; with the unsharded segmented and one-call results."""
    cfg, problem, _ = setup
    hc = dataclasses.replace(cfg.hc, max_steps=12, segment_steps=4,
                             init_delta_t=0.05)
    x0, tgt, _ = (torch.as_tensor(a) for a in _workload(setup, 6, 8,
                                                         trivial=[1]))
    seg = segmented.make_segmented_track_fn(problem, hc)(x0, tgt)
    one = fused.make_track_fn(problem, hc)(x0, tgt)
    assert seg.track.converged.any()
    return hc, x0, tgt, seg, one


@pytest.mark.parametrize("backend", ["segmented", "fused"])
@pytest.mark.parametrize("k", [2, 3])
def test_sharded_equals_unsharded(setup, small, k, backend):
    _, problem, _ = setup
    hc, x0, tgt, seg, one = small
    track = pmesh.make_sharded_track_fn(problem, hc, ["cpu"] * k,
                                        backend=backend)
    if backend == "segmented":
        r = track(x0, tgt)
        assert (r.found, r.found_path, r.best_support, r.best_path) == (
            False, -1, -1, -1)
        _same(r.track, seg.track)
    else:
        _same(track(x0, tgt), one)


@pytest.mark.parametrize("k,trivial_shard", [(4, 0), (2, 1)])
def test_cross_shard_abort_stops_other_shards(setup, k, trivial_shard):
    cfg, problem, view = setup
    H, T = 4, 8
    per = H // k
    hc = dataclasses.replace(cfg.hc, max_steps=16, segment_steps=2,
                             init_delta_t=0.5, truncate_paths=False)
    rc = dataclasses.replace(cfg.ransac, abort_by_good_sol=True,
                             pass_inlier_support_ratio=0.0, imag_part_tol=1e9)
    x0, tgt, _ = (torch.as_tensor(a) for a in _workload(
        setup, H, T, trivial=[trivial_shard * per]))
    edgels = torch.as_tensor(view.edge_locations[:64])
    track = pmesh.make_sharded_track_fn(problem, hc, ["cpu"] * k,
                                        ransac_cfg=rc)
    res = track(x0, tgt, edgels, torch.eye(3), 64)
    lo, hi = trivial_shard * per * T, (trivial_shard + 1) * per * T
    assert res.found
    assert lo <= res.found_path < hi     # a global index in that shard
    assert res.best_support >= 0 and 0 <= res.best_path < H * T
    others = torch.ones(H * T, dtype=torch.bool)
    others[lo:hi] = False
    assert not res.track.converged[others].any()
    assert int(res.track.num_steps[others].max()) < hc.max_steps


def _finishing(setup, k, trivial_shard):
    """hc, x0, target: one hypothesis a shard over the first 8 roots, the
    shard ``trivial_shard``'s targeting the start parameters (its paths end
    within the first segment of 4 steps; the others' run 16), the abort
    off."""
    cfg = setup[0]
    hc = dataclasses.replace(cfg.hc, max_steps=16, segment_steps=4,
                             init_delta_t=0.5)
    x0, tgt, _ = (torch.as_tensor(a) for a in _workload(
        setup, k, 8, trivial=[trivial_shard]))
    return hc, x0, tgt


def _drive(run):
    run.advance()
    while run.keep():
        run.advance()
    return run.result().track


@pytest.mark.parametrize("k,trivial_shard", [(2, 0), (4, 3)])
def test_loop_test_is_exchanged_between_shards(setup, monkeypatch, k,
                                               trivial_shard):
    _, problem, _ = setup
    hc, x0, tgt = _finishing(setup, k, trivial_shard)
    one = segmented.make_segmented_track_fn(problem, hc)(x0, tgt).track
    track = pmesh.make_sharded_track_fn(problem, hc, ["cpu"] * k)
    run = track.begin(x0, tgt)
    run.advance()
    assert run.keep()
    active = [r.n_active for r in run.runs]
    assert active[trivial_shard] == 0
    assert any(a > 0 for i, a in enumerate(active) if i != trivial_shard)
    run.advance()
    while run.keep():
        run.advance()
    _same(run.result().track, one)

    others = torch.ones(x0.shape[0], dtype=torch.bool)
    others[trivial_shard * 8:(trivial_shard + 1) * 8] = False

    def keep(self):          # the finished shard's loop test alone
        going, found = self.runs[trivial_shard].poll()
        return going and not found

    monkeypatch.setattr(pmesh._ShardedRun, "keep", keep)
    short = _drive(track.begin(x0, tgt))
    assert int(short.num_steps[others].max()) <= hc.segment_steps < int(
        one.num_steps[others].max())


def _kids(sp, i, name=None):
    return [j for j, s in enumerate(sp)
            if s[3] == i and (name is None or s[0] == name)]


@pytest.mark.parametrize("k", [2, 4])
def test_mesh_spans(setup, monkeypatch, k):
    _, problem, _ = setup
    hc, x0, tgt = _finishing(setup, k, 0)
    made, order = [], []
    init, advance = segmented._Run.__init__, segmented._Run.advance

    def spy_init(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    def spy_advance(self):
        order.append(made.index(self))
        advance(self)

    monkeypatch.setattr(segmented._Run, "__init__", spy_init)
    monkeypatch.setattr(segmented._Run, "advance", spy_advance)
    track = pmesh.make_sharded_track_fn(problem, hc, ["cpu"] * k)
    rec = spans.Recorder()
    with spans.recording(rec), spans.span("top"):
        track(x0, tgt)
    sp = rec.spans_out()
    n = made[0].si
    assert n >= 2 and all(r.si == n for r in made) and len(made) == k
    assert order == list(range(k)) * n      # shard order, every boundary
    top = [sp[j][0] for j in _kids(sp, 0)]
    assert top == (["mesh.scatter"] + ["mesh.advance", "mesh.keep"] * n
                   + ["mesh.gather"])
    for i in _kids(sp, 0, "mesh.advance"):
        assert [sp[j][0] for j in _kids(sp, i)] == [
            "segment.launch", "segment.boundary"] * k
    for i in _kids(sp, 0, "mesh.keep"):
        assert [sp[j][0] for j in _kids(sp, i)] == ["segment.wait"] * k
    for i in _kids(sp, 0, "mesh.scatter") + _kids(sp, 0, "mesh.gather"):
        assert _kids(sp, i) == []
    assert [s[0] for s in sp].count("segment.launch") == k * n


def test_one_device_round_has_no_mesh_spans(setup):
    cfg, _, view = setup
    cfg = dataclasses.replace(cfg, hc=dataclasses.replace(
        cfg.hc, max_steps=2, segment_steps=1))
    rr = engine.TrifocalPoseEngine(cfg, device="cpu").run_round(
        view, seed=0, num_hypotheses=1)
    names = [s[0] for s in rr.spans]
    assert "segment.launch" in names
    assert not [n for n in names if n.startswith("mesh.")]


def test_engine_round_matches_jax_engine(setup):
    cfg, _, view = setup
    base = dataclasses.replace(cfg, hc=dataclasses.replace(
        cfg.hc, max_steps=12, backend="xla", predictor_handoff=False))
    port = engine.TrifocalPoseEngine(dataclasses.replace(base, num_devices=4),
                                     device=["cpu"] * 4)
    assert port.track.backend == "xla" and len(port.track.mesh) == 4
    rr = port.run_round(view, seed=0, num_hypotheses=4)
    jcfg = dataclasses.replace(base, problem=config.problem_config(cfg),
                               num_devices=4)
    rj = jengine.TrifocalPoseEngine(jcfg).run_round(view, seed=0,
                                                    num_hypotheses=4)
    n_paths = 4 * port.problem.num_tracks
    assert rr.stats.num_paths == n_paths
    band = int(_FLIP_FRAC * n_paths)
    assert abs(rr.stats.num_converged - rj.stats.num_converged) <= band
    assert abs(rr.stats.num_infinity - rj.stats.num_infinity) <= band
    tol = max(5, int(0.002 * view.edge_locations.shape[0]))
    assert abs(rr.best_support21 - rj.best_support21) <= tol
    assert abs(rr.best_support31 - rj.best_support31) <= tol


@pytest.mark.parametrize("seed,h", [(0, 3), (7, 100)])
def test_padded_samples_begin_with_the_unpadded(setup, seed, h):
    """sample_edgel_triplets draws hypothesis by hypothesis: the first h
    rows of a draw padded to whole shards are the unpadded draw."""
    n = setup[2].edge_locations.shape[0]
    for hp in (h + 1, -(-h // 4) * 4, h + 2):
        np.testing.assert_array_equal(
            ransac.sample_edgel_triplets(seed, n, hp)[:h],
            ransac.sample_edgel_triplets(seed, n, h))


def test_engine_pads_to_whole_shards(setup):
    """H = 3 over 2 shards: the round equals the unsharded round path for
    path; with the abort, abort_chunk 1 becomes chunks of 2 hypotheses."""
    cfg, _, view = setup
    cfg = dataclasses.replace(cfg, hc=dataclasses.replace(
        cfg.hc, max_steps=1, segment_steps=1))
    one = engine.TrifocalPoseEngine(cfg, device="cpu")
    two = engine.TrifocalPoseEngine(dataclasses.replace(cfg, num_devices=2),
                                    device=["cpu", "cpu"])
    calls = []
    track = two.track

    def recorded(x0, tgt, *a):
        calls.append(x0.shape[0])
        return track(x0, tgt, *a)

    two.track = recorded
    r1, r2 = (e.run_round(view, seed=0, num_hypotheses=3)
              for e in (one, two))
    T = one.problem.num_tracks
    assert calls == [4 * T] and r2.stats.num_paths == 3 * T
    for f in ("converged", "inf_fail", "pruned", "num_steps"):
        np.testing.assert_array_equal(getattr(r1, f), getattr(r2, f), f)

    abort = dataclasses.replace(cfg, num_devices=2, ransac=dataclasses.replace(
        cfg.ransac, abort_by_good_sol=True, abort_chunk=1))
    ea = engine.TrifocalPoseEngine(abort, device=["cpu", "cpu"])
    calls.clear()
    track = ea.track
    ea.track = recorded
    ra = ea.run_round(view, seed=0, num_hypotheses=3)
    assert calls == [2 * T] * 2 and ra.chunks_run == 2
    assert ra.stats.num_paths == 3 * T


def test_engine_refuses_a_single_device_for_shards(setup):
    cfg = dataclasses.replace(setup[0], num_devices=2)
    with pytest.raises(ValueError, match="list of 2 devices"):
        engine.TrifocalPoseEngine(cfg, device="cpu")
    with pytest.raises(ValueError, match="num_devices=2 but 3"):
        engine.TrifocalPoseEngine(cfg, device=["cpu"] * 3)
