"""The boundary scoring kernel (csrc/hc_score.cu, ``_kernels.hc_score``).

On the CPU (the tier-1 tests):

* a CPU ``_Run`` scores with the plain body (``_score_plain``): the
  kernel's launch count does not move, and its outcome records
  ``score_slots`` and ``scored_paths`` as before;
* ``_kernels.hc_score`` refuses CPU tensors and every wrong dtype or shape
  before it loads a library;
* the slot count has one owner: an abort tracker's first workspace builds
  the tracker's variant and the scoring's library, built with
  ``-DSLOTS=segmented._SCORE_SLOTS``, in one ``build`` call, once, and
  sizes the workspace from that library.

On the card (marked ``gpu``; this file imports no jax):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_score_kernel.py

the kernel equals the plain body bit for bit (``scored``, ``found``,
``found_path``, ``best_supp``, ``best_path``) after one and after several
boundaries, on seeded states of view 0's edgels: 0, 1, 127, 128, 129 and
all paths newly converged; fewer paths than slots; a found flag carried
from an earlier boundary; hits in several slots and ties in support (poses
at the ground truth, so the first in slot order wins); imaginary parts
exactly at imag_part_tol and just under it; NaN in a pose row; edgel counts
that are no multiple of the block.  And a whole abort chunk of view 0
(chunks of 12 hypotheses, seed 0) tracked with the kernel's scoring and
with the plain body gives the same ``SegmentedResult``, bit for bit.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch import engine
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    _kernels,
    fused,
    ransac,
    segmented,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
    config,
    data_io,
    spans,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")
_S = segmented._SCORE_SLOTS
_OUT = ("scored", "found", "found_path", "best_supp", "best_path")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads (see tests/test_torch_engine.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    cfg = config.EngineConfig(data_root=DATA)
    cfg = dataclasses.replace(cfg, ransac=dataclasses.replace(
        cfg.ransac, abort_by_good_sol=True, abort_chunk=12))
    d = config.ransac_data_dir(cfg)
    view = data_io.load_ransac_view(d, 0)
    kmat = data_io.load_intrinsic_matrix(d)
    return cfg, trifocal.TrifocalProblem.load(cfg), view, kmat


def _cayley_params(r):
    """The Cayley vector of rotation r (the inverse of cayley_to_rotation)."""
    return np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0],
                     r[1, 0] - r[0, 1]]) / (1.0 + np.trace(r))


def _run(problem, dev, B, n_edgels=None):
    """A scoring run of B paths on ``dev`` (its tracking state is replaced
    by ``_install``), over the first ``n_edgels`` edgels of view 0."""
    cfg, port, view, kmat = problem
    track = segmented.make_segmented_track_fn(port, cfg.hc, cfg.ransac)
    edgels = view.edge_locations[:n_edgels]
    tgt = ransac.build_target_params(view.edge_locations, view.edge_tangents,
                                     np.array([[0, 1, 2]]))
    x0 = torch.as_tensor(np.resize(port.start_sols, (B, 30)), device=dev)
    tg = torch.as_tensor(np.repeat(tgt, B, axis=0), device=dev)
    return track.begin(x0, tg, torch.as_tensor(edgels, device=dev),
                       torch.as_tensor(kmat, device=dev), len(edgels))


def _state(problem, rows, B, newly, seed=0):
    """A seeded packed state of B paths, ``newly`` of them (-1: all)
    newly converged: x (poses at the ground truth, nudged off it or random,
    small or large imaginary parts, some exactly at imag_part_tol or just
    under it, some NaN), flags, scored marks and the packing order."""
    cfg, _, view, _ = problem
    rng = np.random.default_rng(seed)
    gt = np.concatenate([view.gt_pose21[:, 3], view.gt_pose31[:, 3],
                         _cayley_params(view.gt_pose21[:, :3]),
                         _cayley_params(view.gt_pose31[:, :3])])
    kind = rng.choice(5, p=[0.35, 0.25, 0.2, 0.1, 0.1], size=B)
    pose = np.where((kind == 1)[:, None],
                    gt * (1 + rng.choice([1e-4, 1e-2], size=(B, 1))
                          * rng.standard_normal((B, 12))), gt)
    pose = np.where((kind == 2)[:, None], rng.standard_normal((B, 12)), pose)
    imag = rng.choice([1e-8, 1e-3], p=[0.85, 0.15], size=(B, 1)) * \
        rng.standard_normal((B, 12))
    x = (rng.standard_normal((B, 30))
         + 1j * rng.standard_normal((B, 30))).astype(np.complex64)
    x[:, rows] = (pose + 1j * imag).astype(np.complex64)
    tol = np.float32(cfg.ransac.imag_part_tol)
    col = rows[rng.integers(12, size=B)]
    at = kind == 3            # one pose component's |imag| at the gate
    x[at, col[at]] = x[at, col[at]].real + 1j * np.where(
        rng.random(at.sum()) < 0.5, tol, np.nextafter(tol, np.float32(0)))
    nan = kind == 4           # NaN in a real or an imaginary pose part
    x[nan, col[nan]] = np.where(rng.random(nan.sum()) < 0.5,
                                np.complex64(complex(np.nan, 0.0)),
                                np.complex64(complex(0.5, np.nan)))
    fl = fused.init_flags(cfg.hc, B).numpy()
    n = B if newly < 0 else newly
    new = np.zeros(B, bool)
    new[rng.choice(B, n, replace=False)] = True
    done = ~new & (rng.random(B) < 0.5)   # converged and already scored
    fl[:, fused._F_T] = np.where(
        new | done, rng.choice(np.float32([1.0, 1.0 - 5e-8]), size=B),
        rng.choice(np.float32([0.0, 0.5, 0.99]), size=B))
    return dict(x=x, fl=fl, scored=done, order=rng.permutation(B))


def _install(run, st, found=None, best=None):
    """Put state ``st`` into ``run``, with an earlier boundary's found path
    and best support if given."""
    dev = run.dev
    run.x = torch.as_tensor(st["x"], device=dev)
    run.fl = torch.as_tensor(st["fl"], device=dev)
    run.scored = torch.as_tensor(st["scored"], device=dev)
    run.order = torch.as_tensor(st["order"], device=dev)
    if found is not None:
        run.found = torch.tensor(True, device=dev)
        run.found_path = torch.tensor(found, device=dev)
    if best is not None:
        run.best_supp = torch.tensor(best[0], device=dev)
        run.best_path = torch.tensor(best[1], device=dev)


def _outcome(run):
    return [getattr(run, k).cpu().numpy() for k in _OUT]


# -- the CPU ------------------------------------------------------------------


def test_cpu_run_scores_with_the_plain_body(problem, monkeypatch):
    """Two boundaries of a CPU run: the plain body runs, the kernel's count
    stays, and the outcome's counters are the plain body's."""
    plain = []
    body = segmented._Run._score_plain

    def spy(self):
        plain.append(self)
        body(self)

    monkeypatch.setattr(segmented._Run, "_score_plain", spy)
    run = _run(problem, "cpu", 300)
    _install(run, _state(problem, run.pose_rows.numpy(), 300, 200))
    launches = _kernels.hc_score.launches
    rec = spans.Recorder()
    with spans.recording(rec):
        run._boundary()
        run._boundary()
        run.outcome()
    assert plain == [run, run]
    assert _kernels.hc_score.launches == launches
    assert rec.counts["score_slots"] == 2 * _S
    assert rec.counts["scored_paths"] == int(run.scored.sum())


def _args(B=5, N=7):
    """hc_score's arguments, right but for their device (the CPU)."""
    return dict(
        x=torch.zeros(B, 30, dtype=torch.complex64),
        fl=torch.zeros(B, 8), scored=torch.zeros(B, dtype=torch.bool),
        order=torch.arange(B), pose_rows=torch.arange(12),
        edgels=torch.zeros(N, 6), kmat=torch.eye(3),
        found=torch.tensor(False), found_path=torch.tensor(-1),
        best_supp=torch.tensor(-1), best_path=torch.tensor(-1),
        work=torch.zeros(1 + 4 * _S, dtype=torch.int32), slots=_S,
        t_col=fused._F_T, t_eps=1e-7, imag_tol=1e-5, thresh=2.0, need=6.3)


_FAULTS = {
    "cpu": {},
    "x_dtype": dict(x=torch.zeros(5, 30, dtype=torch.complex128)),
    "x_shape": dict(x=torch.zeros(5, 29, dtype=torch.complex64)),
    "x_empty": dict(x=torch.zeros(0, 30, dtype=torch.complex64)),
    "fl_dtype": dict(fl=torch.zeros(5, 8, dtype=torch.float64)),
    "fl_shape": dict(fl=torch.zeros(6, 8)),
    "scored_dtype": dict(scored=torch.zeros(5, dtype=torch.uint8)),
    "order_dtype": dict(order=torch.arange(5, dtype=torch.int32)),
    "pose_rows_shape": dict(pose_rows=torch.arange(11)),
    "edgels_shape": dict(edgels=torch.zeros(7, 5)),
    "kmat_dtype": dict(kmat=torch.eye(3, dtype=torch.float64)),
    "found_shape": dict(found=torch.zeros(1, dtype=torch.bool)),
    "best_supp_dtype": dict(best_supp=torch.tensor(-1, dtype=torch.int32)),
    "work_shape": dict(work=torch.zeros(1, 4 * _S + 1, dtype=torch.int32)),
    "work_dtype": dict(work=torch.zeros(1 + 4 * _S, dtype=torch.int64)),
}


@pytest.mark.parametrize("fault", list(_FAULTS))
def test_hc_score_refuses_before_loading(monkeypatch, fault):
    def no_load(*a, **kw):
        raise AssertionError("a library was loaded")

    monkeypatch.setattr(_kernels, "load", no_load)
    monkeypatch.setattr(_kernels, "build", no_load)
    monkeypatch.setattr(_kernels, "_score_fns", {})
    with pytest.raises(ValueError,
                       match="CUDA" if fault == "cpu" else "must be"):
        _kernels.hc_score(**{**_args(), **_FAULTS[fault]})


# A stand-in for hc_score's library: its launch function and its
# workspace's words.
_LIB = types.SimpleNamespace(hc_score_launch=types.SimpleNamespace(),
                             hc_score_work_words=lambda: 1 + 4 * _S)


def test_workspace_builds_both_libraries(problem, monkeypatch):
    """An abort tracker's first workspace builds its variant and the
    scoring's library (the slots the tracker's) in one call; the next
    builds nothing; the workspace is as long as the library says."""
    built, loaded = [], []
    monkeypatch.setattr(_kernels, "build", built.append)
    monkeypatch.setattr(_kernels, "load",
                        lambda *job: loaded.append(job) or _LIB)
    monkeypatch.setattr(_kernels, "_score_fns", {})
    cfg, port, _, _ = problem
    tr = segmented._Tracker(port, cfg.hc, cfg.ransac, False)
    works = [tr.score_workspace("cpu") for _ in range(2)]
    assert built == [[_kernels._hc_track_job(cfg.hc),
                      ("hc_score", "hc_score", (f"-DSLOTS={_S}",))]]
    assert loaded == [("hc_score", "hc_score", (f"-DSLOTS={_S}",))]
    for work in works:
        assert work.dtype == torch.int32 and not work.any()
        assert work.shape == (1 + 4 * _S,)


# -- the card -----------------------------------------------------------------


@pytest.fixture(scope="module")
def card(problem):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a GPU")
    return torch.device("cuda")


# (paths, newly converged paths (-1: all), edgels (None: all 5,117), an
# earlier found path, an earlier best (support, path))
_STATES = {
    "none_new": (600, 0, None, None, None),
    "one_new": (600, 1, None, None, None),
    "127_new": (600, 127, None, None, None),
    "128_new": (600, 128, None, None, None),
    "129_new": (600, 129, None, None, None),
    "all_new": (600, -1, None, None, None),
    "below_slots": (50, 30, None, None, None),
    "below_slots_all_new": (50, -1, None, None, None),
    "one_path": (1, -1, None, None, None),
    "found_carried": (600, 300, None, 4321, (5000, 17)),
    "best_unbeaten": (600, 300, None, None, (6000, 3)),
    "edgels_37": (600, 200, 37, None, None),
    "edgels_300": (600, 200, 300, None, None),
}


# The states whose slots hold poses at the ground truth.
_HITS = {"127_new", "128_new", "129_new", "all_new", "below_slots_all_new",
         "found_carried", "best_unbeaten", "edgels_37", "edgels_300"}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_STATES))
def test_kernel_equals_plain_body(problem, card, name):
    """Four boundaries of the same state, the kernel against the plain
    body on the card, each boundary's outcome bit for bit."""
    B, newly, n_edgels, found, best = _STATES[name]
    kern, plain = (_run(problem, card, B, n_edgels) for _ in range(2))
    st = _state(problem, kern.pose_rows.cpu().numpy(), B, newly,
                seed=len(name))
    for run in (kern, plain):
        _install(run, st, found, best)
    launches = _kernels.hc_score.launches
    for boundary in range(4):
        kern._score_new()
        plain._score_plain()
        for k, a, b in zip(_OUT, _outcome(kern), _outcome(plain)):
            np.testing.assert_array_equal(a, b, err_msg=f"{k}, boundary "
                                          f"{boundary}")
    assert _kernels.hc_score.launches == launches + 4
    if name in _HITS:
        # Passing poses were scored, several of them tied at the best.
        assert bool(plain.found) and int(plain.best_supp) >= 0


@pytest.mark.gpu
def test_abort_chunk_both_ways(problem, card, monkeypatch):
    """Chunk 0 of view 0's abort round (12 hypotheses of seed 0), tracked
    with the kernel's scoring and with the plain body: the same
    SegmentedResult."""
    cfg, _, view, _ = problem
    port = engine.TrifocalPoseEngine(cfg)
    H = cfg.ransac.abort_chunk
    samples = ransac.sample_edgel_triplets(0, view.edge_locations.shape[0], H)
    tgt = ransac.build_target_params(view.edge_locations, view.edge_tangents,
                                     samples)
    T = port.problem.num_tracks
    tg = torch.as_tensor(tgt, device=card).repeat_interleave(T, dim=0)
    x0 = port._start.repeat(H, 1)
    edgels = torch.as_tensor(view.edge_locations, device=card)
    n = view.edge_locations.shape[0]
    launches = _kernels.hc_score.launches
    kern = port.track(x0, tg, edgels, port._k, n)
    k_launches = _kernels.hc_score.launches - launches
    monkeypatch.setattr(segmented._Run, "_score_new",
                        segmented._Run._score_plain)
    plain = port.track(x0, tg, edgels, port._k, n)
    assert _kernels.hc_score.launches == launches + k_launches
    assert k_launches >= 1
    for f in ("found", "found_path", "best_support", "best_path"):
        assert getattr(kern, f) == getattr(plain, f), f
    assert kern.found
    a, b = kern.track, plain.track
    assert torch.equal(torch.view_as_real(a.x).view(torch.int32).cpu(),
                       torch.view_as_real(b.x).view(torch.int32).cpu())
    for f in ("converged", "inf_fail", "pruned", "num_steps"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()), f
