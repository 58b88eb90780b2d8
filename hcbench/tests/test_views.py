"""The traffic generator: exact mismatch share, inlier rows that agree with
their ground truth, determinism from the seed."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from hcbench import run, views  # noqa: E402
from hcbench.plain import config as plain_config  # noqa: E402
from hcbench.plain.data_io import load_intrinsic_matrix  # noqa: E402


@pytest.fixture(scope="module")
def k_mat():
    cfg = run.engine_config(plain_config, {"data_root": "data/synth_trifocal"})
    return load_intrinsic_matrix(
        plain_config.ransac_data_dir(cfg)).astype(np.float64)


def _traffic(share, n=1000, pool=3):
    return {"driver": "closed_loop", "clients": 1, "pool_views": pool,
            "edgels_per_view": n, "mismatch_share": share, "depth": 1000.0}


def _epipolar(view, rows):
    """|g_v^T [t]x R g_1| for views 2 and 3 over rows (metric points)."""
    g = view.edge_locations.astype(np.float64)
    g1 = np.c_[g[rows, 0:2], np.ones(len(rows))]
    out = []
    for (r, t), cols in ((view.pose21, slice(2, 4)), (view.pose31,
                                                      slice(4, 6))):
        gv = np.c_[g[rows, cols], np.ones(len(rows))]
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        e = tx @ r / np.linalg.norm(t)
        out.append(np.abs(np.einsum("ni,ij,nj->n", gv, e, g1)))
    return np.maximum(*out)


@pytest.mark.parametrize("share", [0.0, 0.09, 0.3])
def test_mismatch_share_is_exact(k_mat, share):
    for v in views.make_pool(_traffic(share), 7, k_mat):
        assert int(v.mismatched.sum()) == int(round(share * 1000))


@pytest.mark.parametrize("share", [0.0, 0.3])
def test_inlier_rows_agree_with_their_poses(k_mat, share):
    for v in views.make_pool(_traffic(share), 11, k_mat):
        inl = np.nonzero(~v.mismatched)[0]
        # float32 coordinates of points ~0.1 apart: 1e-6 is rounding.
        assert _epipolar(v, inl).max() < 1e-6
        if share:
            bad = np.nonzero(v.mismatched)[0]
            assert np.median(_epipolar(v, bad)) > 1e-3
        pix = np.c_[v.edge_locations[:, 0:2], np.ones(len(inl) + int(
            v.mismatched.sum()))] @ k_mat.T
        assert (pix[:, 0] > 0).all() and (pix[:, 0] < 500).all()
        tn = np.linalg.norm(v.edge_tangents.reshape(-1, 3, 2), axis=2)
        np.testing.assert_allclose(tn, 1.0, atol=1e-6)


def test_pool_is_drawn_from_the_seed(k_mat):
    a = views.make_pool(_traffic(0.3, 500, 2), 2**31 + 5, k_mat)
    b = views.make_pool(_traffic(0.3, 500, 2), 2**31 + 5, k_mat)
    c = views.make_pool(_traffic(0.3, 500, 2), 2**31 + 6, k_mat)
    for x, y in zip(a, b):
        assert np.array_equal(x.edge_locations, y.edge_locations)
        assert np.array_equal(x.mismatched, y.mismatched)
    assert not np.array_equal(a[0].edge_locations, c[0].edge_locations)
    # A view does not depend on the pool's size.
    one = views.make_pool(_traffic(0.3, 500, 1), 2**31 + 5, k_mat)
    assert np.array_equal(one[0].edge_locations, a[0].edge_locations)


def test_request_seeds_differ():
    seeds = {views.request_seed(3_000_000_001, i) for i in range(1000)}
    assert len(seeds) == 1000
    assert views.request_seed(3_000_000_001, 0, views.WARMUP_STREAM) \
        not in seeds
