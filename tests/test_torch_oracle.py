"""The port's oracle tracker (ops/linalg.py, ops/tracker.py) against the
JAX package's, both on the CPU.

``solve_batched``: seeded (B, 30, 30) systems, complex64 and complex128,
row-permuted and diagonally weighted so that the pivot search does work
and the conditioning stays small (the two implementations round
differently, and a badly conditioned system magnifies that); a system
with a zero pivot; and a singular one whose first column ties in
|Re| + |Im|, where the two pivot choices give different answers, so that
agreement shows the same (first) row was picked.  Within 1e-5 relative.

``make_track_fn``: the inputs of tests/test_tracker.py (view 0, sampling
seed 7, one hypothesis, the first 64 roots), the default configuration;
then at 16 paths each of ``dynamic_start=True`` (start = target - diff),
TrunPaths off, float64, predictor rk2 and rk3, corrector_jacobian_reuse=1
and the predictor handoff.  Both trackers are float32 implementations
that round differently, and near-singular path endings turn that into a
different step.  So, as tests/test_torch_tracker.py does, each path is
probed with four 1e-7 relative perturbations of its start root, target
and difference through the port: on the paths whose flags (converged,
inf-fail, pruned) and step counts no perturbation changes, they must equal
the JAX tracker's, and at least 75 % of the paths must be such; x must
agree within 1e-3 relative (per path, floor 1) where both converge.  The
port runs the base run and its perturbations as one batch (paths are
independent) except under the handoff, which is decided over the batch.
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
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import linalg as jlinalg
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import (
    tracker as jtracker,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    linalg,
    ransac,
    tracker,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
    config,
    data_io,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")
_PERTURBATIONS = 4
_FLAGS = ("converged", "inf_fail", "pruned", "num_steps")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads: the tier-1 command runs several pytest workers
    on one CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# solve_batched
# ---------------------------------------------------------------------------


def _systems(dtype, case):
    rng = np.random.default_rng({"seeded": 0, "zero_pivot": 1, "tie": 2}[case])
    B, N = 8, 30
    z = (rng.standard_normal((B, N, N))
         + 1j * rng.standard_normal((B, N, N))) / np.sqrt(2 * N)
    a = z + 2.0 * np.eye(N)
    # Scrambled rows: elimination must pivot to undo them.
    perm = [rng.permutation(N) for _ in range(B)]
    b = rng.standard_normal((B, N)) + 1j * rng.standard_normal((B, N))
    if case == "zero_pivot":
        a[0, :, 0] = 0.0        # step 0 finds only zeros: the pivot is 1
        a[1, :, 5] = 0.0        # a later step does
    elif case == "tie":
        # System 0 is block diagonal with the singular block [[1+1j, 1+1j],
        # [-1-1j, -1-1j]] first: both rows score 2 in column 0, and the
        # two pivot choices give different answers.
        a[0, :2, :] = 0.0
        a[0, :, :2] = 0.0
        a[0, 0, :2] = 1 + 1j
        a[0, 1, :2] = -1 - 1j
        perm[0] = np.arange(N)
    a = np.stack([m[p] for m, p in zip(a, perm)])
    return a.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("case", ["seeded", "zero_pivot", "tie"])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_solve_matches_jax(dtype, case):
    a, b = _systems(dtype, case)
    x = linalg.solve_batched(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    with jax.enable_x64(dtype == np.complex128):
        xj = np.asarray(jlinalg.solve_batched(jnp.asarray(a), jnp.asarray(b)))
    assert x.dtype == xj.dtype == dtype
    assert np.isfinite(x).all()
    rel = np.linalg.norm(x - xj, axis=1) / np.linalg.norm(xj, axis=1)
    assert rel.max() < 1e-5, rel
    if case == "tie":
        # Row 0 as pivot: row 1 becomes 0, its pivot is replaced by 1, and
        # x_0 + x_1 = b_0 / (1+1j); row 1 would give -b_1 / (1+1j).
        s = x[0, 0] + x[0, 1]
        assert abs(s - b[0, 0] / (1 + 1j)) < 1e-5 * abs(s)


def test_solve_is_not_torch_linalg():
    """On a system with a zero column the oracle replaces the pivot by 1
    and returns finite values, where LAPACK's solve refuses."""
    a, b = _systems(np.complex64, "zero_pivot")
    with pytest.raises(RuntimeError):
        torch.linalg.solve(torch.as_tensor(a), torch.as_tensor(b))
    assert torch.isfinite(linalg.solve_batched(torch.as_tensor(a),
                                               torch.as_tensor(b))).all()


# ---------------------------------------------------------------------------
# make_track_fn
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    cfg = config.EngineConfig(data_root=DATA)
    jcfg = dataclasses.replace(cfg, problem=config.problem_config(cfg))
    port = trifocal.TrifocalProblem.load(cfg)
    jp = jtrifocal.TrifocalProblem.load(jcfg)
    view = data_io.load_ransac_view(config.ransac_data_dir(cfg), 0)
    s = ransac.sample_edgel_triplets(7, view.edge_locations.shape[0], 1)
    tgt = ransac.build_target_params(view.edge_locations, view.edge_tangents,
                                     s)
    return cfg, port, jp, tgt


def _inputs(setup, n):
    _, port, _, tgt = setup
    tgt_b = np.repeat(tgt, n, axis=0)
    diff_b = (tgt_b - port.start_params).astype(np.complex64)
    return np.asarray(port.start_sols)[:n], tgt_b, diff_b


def _port_runs(track, x0, tgt, diff, batch: bool):
    """The port's result on the inputs and on _PERTURBATIONS copies nudged
    by 1e-7 relative; a list of dicts of numpy arrays."""
    runs = [(x0, tgt, diff)]
    for seed in range(_PERTURBATIONS):
        rng = np.random.default_rng(seed)

        def nudge(a):
            return (a * (1 + 1e-7 * rng.standard_normal(a.shape))).astype(
                a.dtype)

        runs.append((nudge(x0), nudge(tgt), nudge(diff)))
    n = len(x0)

    def call(x, t, d):
        r = track(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(d))
        return {f: getattr(r, f).numpy() for f in ("x",) + _FLAGS}

    if not batch:
        return [call(*r) for r in runs]
    out = call(*(np.concatenate(parts) for parts in zip(*runs)))
    return [{f: v[i * n:(i + 1) * n] for f, v in out.items()}
            for i in range(len(runs))]


def _compare(setup, n, dtype=np.float32, dynamic_start=False, **knobs):
    cfg, port, jp, _ = setup
    hc = dataclasses.replace(cfg.hc, **knobs)
    x0, tgt, diff = _inputs(setup, n)
    with jax.enable_x64(dtype == np.float64):
        jr = jtracker.make_track_fn(jp, hc, dynamic_start=dynamic_start,
                                    dtype=dtype)(x0, tgt, diff)
    track = tracker.make_track_fn(
        port, hc, dynamic_start=dynamic_start,
        dtype=torch.float64 if dtype == np.float64 else torch.float32)
    runs = _port_runs(track, x0, tgt, diff,
                      batch=not hc.predictor_handoff)
    base = runs[0]
    assert base["x"].dtype == (np.complex128 if dtype == np.float64
                               else np.complex64)
    stable = np.ones(n, bool)
    for r in runs[1:]:
        for f in _FLAGS:
            stable &= r[f] == base[f]
    assert stable.sum() >= 0.75 * n, stable.sum()
    for f in _FLAGS:
        np.testing.assert_array_equal(base[f][stable],
                                      np.asarray(getattr(jr, f))[stable], f)
    both = base["converged"] & np.asarray(jr.converged)
    scale = np.maximum(np.abs(jr.x).max(axis=1), 1.0)
    err = np.abs(base["x"] - jr.x).max(axis=1) / scale
    assert (err[both] < 1e-3).all(), err[both]
    return base, stable


def test_tracker_matches_jax(setup):
    base, stable = _compare(setup, 64)
    # The window holds real outcomes: converged and pruned paths.
    assert base["converged"][stable].any() and base["pruned"][stable].any()


@pytest.mark.parametrize("variant", [
    dict(dynamic_start=True), dict(truncate_paths=False),
    dict(dtype=np.float64), dict(predictor="rk2"), dict(predictor="rk3"),
    dict(corrector_jacobian_reuse=1), dict(predictor_handoff=True, tile=1),
], ids=["dynamic_start", "trunpaths_off", "float64", "rk2", "rk3", "cjr1",
        "handoff"])
def test_tracker_variant_matches_jax(setup, variant):
    _compare(setup, 16, **variant)


def test_tracker_needs_diff_with_dynamic_start(setup):
    _, port, _, _ = setup
    x0, tgt, _ = _inputs(setup, 2)
    track = tracker.make_track_fn(port, setup[0].hc, dynamic_start=True)
    with pytest.raises(ValueError, match="diff_params"):
        track(torch.as_tensor(x0), torch.as_tensor(tgt))


def test_tracker_default_diff_is_the_engines(setup):
    """diff_params=None is target - start in complex64, as the JAX engine
    forms it: the same result as passing that difference."""
    cfg, port, _, _ = setup
    hc = dataclasses.replace(cfg.hc, max_steps=6)
    x0, tgt, diff = _inputs(setup, 8)
    track = tracker.make_track_fn(port, hc)
    a = track(torch.as_tensor(x0), torch.as_tensor(tgt))
    b = track(torch.as_tensor(x0), torch.as_tensor(tgt), torch.as_tensor(diff))
    for f in ("x",) + _FLAGS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
