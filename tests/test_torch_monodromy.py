"""Monodromy start-system generation (models/monodromy.py) on the CPU, and
the per-path start systems it brings to the kernel's tracker.

* The refiner polishes 16 committed roots at the start parameters:
  residual below 1e-3 and a shift below 1e-2 (the JAX package's bounds).
* ``write_start_system`` round-trips through the port's data reader.
* ``monodromy_solve`` on the port's oracle against the JAX package's on
  its own oracle: 24 seed roots, target 30, legs of 32 paths, one loop,
  rng_seed 2 (tests/test_monodromy.py's run, one loop of it).  The same
  waypoints are drawn, the same growth history comes out, and the root
  sets match within 1e-3; every root is a committed root within 1e-2.
* ``fused.build_pair_coefs`` with per-path start parameters equals, bit
  for bit, a numpy re-derivation of the JAX package's forming
  (ops/fused.py, ``build_pair_coefs`` with ``dynamic_start``): s = target
  - diff per plane, then E/F/G or A/B/C from it, for both bases.
* The entry points need a card unless they are asked for the CPU.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
    monodromy as jmonodromy,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
    trifocal as jtrifocal,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import (
    tracker as jtracker,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import (
    monodromy,
    trifocal,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    fused,
    ransac,
    tracker,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
    config,
    data_io,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    cfg = config.EngineConfig(data_root=DATA)
    jcfg = dataclasses.replace(cfg, problem=config.problem_config(cfg))
    return (cfg, trifocal.TrifocalProblem.load(cfg),
            jtrifocal.TrifocalProblem.load(jcfg))


def test_refiner_polishes_committed_roots(setup):
    _, port, _ = setup
    refine = monodromy.make_refiner(port, batch=32, device="cpu")
    x = np.asarray(port.start_sols)[:16]
    xr, res = refine(x, np.asarray(port.start_params))
    assert xr.shape == x.shape and xr.dtype == np.complex64
    assert res.shape == (16,) and res.max() < 1e-3
    assert np.abs(xr - x).max() < 1e-2


def test_write_start_system_round_trips(setup, tmp_path):
    _, port, _ = setup
    res = monodromy.MonodromyResult(
        params=np.asarray(port.start_params),
        solutions=np.asarray(port.start_sols)[:5], loops_run=0, history=[])
    pp, ps = tmp_path / "start_params.txt", tmp_path / "start_sols.txt"
    monodromy.write_start_system(str(pp), str(ps), res)
    sols = data_io._load_complex(str(ps)).reshape(5, port.num_vars)
    assert np.array_equal(sols, res.solutions)
    assert np.array_equal(data_io._load_complex(str(pp)),
                          res.params[:-1])


def test_monodromy_matches_jax_on_the_oracles(setup):
    cfg, port, jp = setup
    hc = dataclasses.replace(cfg.hc, truncate_paths=False)
    seed = np.asarray(port.start_sols)[:24]
    kw = dict(seed_sols=seed, target_count=30, max_loops=1, patience=3,
              rng_seed=2, leg_batch=32)
    ours = monodromy.monodromy_solve(
        port, hc, track_fn=tracker.make_track_fn(port, hc,
                                                 dynamic_start=True),
        device="cpu", **kw)
    ref = jmonodromy.monodromy_solve(
        jp, hc, track_fn=jtracker.make_track_fn(jp, hc, dynamic_start=True),
        **kw)
    assert ours.loops_run == ref.loops_run == 1
    assert ours.history == ref.history and ours.history[-1] > 24
    assert np.array_equal(ours.params, ref.params)
    a, b = ours.solutions, ref.solutions
    assert np.array_equal(a[:24], b[:24])
    d = np.abs(a[:, None] - b[None]).max(axis=-1)
    assert d.min(axis=1).max() < 1e-3 and d.min(axis=0).max() < 1e-3
    ship = np.asarray(port.start_sols)
    for s in a:
        assert np.min(np.max(np.abs(ship - s[None]), axis=1)) < 1e-2


def _jax_dynamic_coefs(problem, tgt, diff, basis):
    """ops/fused.py's build_pair_coefs with dynamic_start, in numpy f32
    planes, batch-first: (E, F, G) or (A, B, C) as (B, Q) planes."""
    f32 = np.float32
    f = problem.factored
    pa, pb = np.asarray(f.pp_a), np.asarray(f.pp_b)
    tr, ti = tgt.real.astype(f32), tgt.imag.astype(f32)
    dr, di = diff.real.astype(f32), diff.imag.astype(f32)
    da_re, da_im, db_re, db_im = dr[:, pa], di[:, pa], dr[:, pb], di[:, pb]
    sa_re, sa_im = tr[:, pa] - da_re, ti[:, pa] - da_im
    sb_re, sb_im = tr[:, pb] - db_re, ti[:, pb] - db_im

    def cmul(ar, ai, br, bi):
        return ar * br - ai * bi, ar * bi + ai * br

    if basis == "efg":
        ta_re, ta_im, tb_re, tb_im = tr[:, pa], ti[:, pa], tr[:, pb], ti[:, pb]
        e = cmul(ta_re, ta_im, tb_re, tb_im)
        fr = ta_re * sb_re - ta_im * sb_im + sa_re * tb_re - sa_im * tb_im
        fi = ta_re * sb_im + ta_im * sb_re + sa_re * tb_im + sa_im * tb_re
        return e, (fr, fi), cmul(sa_re, sa_im, sb_re, sb_im)
    a = cmul(da_re, da_im, db_re, db_im)
    br = sa_re * db_re - sa_im * db_im + sb_re * da_re - sb_im * da_im
    bi = sa_re * db_im + sa_im * db_re + sb_re * da_im + sb_im * da_re
    return a, (br, bi), cmul(sa_re, sa_im, sb_re, sb_im)


@pytest.mark.parametrize("basis", ["efg", "abc"])
def test_pair_coefs_with_per_path_starts(setup, basis):
    cfg, port, _ = setup
    view = data_io.load_ransac_view(config.ransac_data_dir(cfg), 0)
    s = ransac.sample_edgel_triplets(3, view.edge_locations.shape[0], 4)
    tgt = ransac.build_target_params(view.edge_locations, view.edge_tangents,
                                     s)
    rng = np.random.default_rng(0)
    p_from = np.asarray(port.start_params) + (
        rng.standard_normal(tgt.shape) + 1j * rng.standard_normal(tgt.shape))
    p_from[:, -1] = 1.0
    diff = (tgt - p_from).astype(np.complex64)
    tg, df = torch.as_tensor(tgt), torch.as_tensor(diff)
    got = fused.build_pair_coefs(port, tg, basis, start_params=tg - df,
                                 diff_params=df).numpy()
    want = _jax_dynamic_coefs(port, tgt, diff, basis)
    for i, (re, im) in enumerate(want):
        assert np.array_equal(got[:, i].real, re), (basis, i)
        assert np.array_equal(got[:, i].imag, im), (basis, i)


def test_kernel_tracker_takes_diff_with_dynamic_start_only(setup):
    cfg, port, _ = setup
    x0 = torch.as_tensor(np.asarray(port.start_sols)[:2])
    tgt = torch.as_tensor(np.repeat(port.start_params[None], 2, axis=0))
    with pytest.raises(ValueError, match="dynamic_start needs"):
        fused.make_plain_track_fn(port, cfg.hc, dynamic_start=True)(x0, tgt)
    with pytest.raises(ValueError, match="with dynamic_start only"):
        fused.make_plain_track_fn(port, cfg.hc)(x0, tgt, tgt - tgt)


def test_entry_points_need_a_card(setup, monkeypatch):
    """Without a card and without device="cpu" (--platform cpu) the
    monodromy entry points raise (the command line exits 2)."""
    cfg, port, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        monodromy.monodromy_solve(port, cfg.hc, max_loops=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        monodromy.make_refiner(port, batch=8)
    assert monodromy.main(["--max-loops", "1", "--data-root", DATA]) == 2
