"""The committed data root data/synth_trifocal (tools/make_synth_data.py).

Start roots must be roots: max |H(x, p0)| < 1e-3 (the monodromy refiner's
acceptance tolerance, models/monodromy.py), evaluated in complex128 from
the raw index tables, and pairwise distinct.  Views must be consistent
with their ground truth: under the GT pose every edgel of view 0 is a
reprojection inlier on both view pairs (the data are noiseless).
"""

import os

import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import data_io
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import eval as ev
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import ransac
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import config

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")


@pytest.fixture(scope="module")
def cfg():
    return config.EngineConfig(data_root=DATA)


@pytest.fixture(scope="module")
def problem(cfg):
    return trifocal.TrifocalProblem.load(cfg)


def test_start_roots_are_roots(problem):
    x = torch.as_tensor(problem.start_sols).to(torch.complex128)
    p = torch.as_tensor(problem.start_params).to(torch.complex128)
    h = ev.eval_H_direct(problem, x, p.expand(x.shape[0], -1))
    assert h.abs().max().item() < 1e-3


def test_start_roots_distinct(problem):
    x = problem.start_sols.astype(np.complex128)
    d = np.abs(x[:, None, :] - x[None, :, :]).max(axis=2)
    np.fill_diagonal(d, np.inf)
    assert d.min() > 1e-3


def test_root_count_matches_problem_json(problem):
    assert problem.start_sols.shape == (problem.num_tracks, 30)
    assert problem.num_tracks >= 1


@pytest.mark.parametrize("view_index", [0, 1, 2])
def test_gt_pose_makes_every_edgel_an_inlier(cfg, view_index):
    d = config.ransac_data_dir(cfg)
    view = data_io.load_ransac_view(d, view_index)
    k = torch.as_tensor(data_io.load_intrinsic_matrix(d))
    n = view.edge_locations.shape[0]
    assert n >= 5000
    r21 = torch.as_tensor(view.gt_pose21[:, :3])[None]
    r31 = torch.as_tensor(view.gt_pose31[:, :3])[None]
    t21 = torch.as_tensor(view.gt_pose21[:, 3])[None]
    t31 = torch.as_tensor(view.gt_pose31[:, 3])[None]
    n21, n31 = ransac.count_inlier_support(
        r21, r31, t21, t31, torch.as_tensor(view.edge_locations), k)
    assert int(n21[0]) == n and int(n31[0]) == n


def test_tangents_are_unit(cfg):
    view = data_io.load_ransac_view(config.ransac_data_dir(cfg), 0)
    t = view.edge_tangents.reshape(-1, 3, 2)
    np.testing.assert_allclose(np.linalg.norm(t, axis=2), 1.0, atol=1e-6)
