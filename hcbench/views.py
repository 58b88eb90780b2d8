"""The traffic generator: pools of synthetic trifocal views drawn from a seed.

``make_view`` is a vectorised copy of ``tools/make_synth_data.make_view``
(commit e13ae2fbc8b3): camera 1 is the world frame, cameras 2 and 3 orbit
the object centre at ``depth``, and each correspondence is a 3D point with a
3D tangent direction seen in all three views (metric image coordinates and
unit image tangents), kept only if it lands inside every image.  The
original draws one candidate point at a time; this one draws them in
blocks, so the same seed gives other views than the original's, of the same
distribution.  ``mismatch`` then gives a share of the rows the view-2 and
view-3 entries of another row: wrong correspondences, which RANSAC exists
to reject.

A traffic file (``hcbench/traffic/<name>.json``) holds the parameters that
``make_pool`` reads: ``pool_views``, ``edgels_per_view``,
``mismatch_share`` and ``depth``; the driver named by its ``driver`` key
sends the pool's views as requests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Tags that keep the streams drawn from one --seed apart.
VIEW_STREAM = 1
SAMPLE_STREAM = 2
CHECK_STREAM = 3
WARMUP_STREAM = 4


@dataclasses.dataclass(frozen=True)
class View:
    """One view triplet as a front end holds it, with its ground truth."""

    edge_locations: np.ndarray  # float32 (N, 6): (x, y) in views 1, 2, 3
    edge_tangents: np.ndarray   # float32 (N, 6): unit (tx, ty) per view
    pose21: tuple               # (R (3, 3), t (3,)) float64, view 1 -> 2
    pose31: tuple               # the same, view 1 -> 3
    mismatched: np.ndarray      # bool (N,): rows whose views 2-3 are wrong


def rng_for(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    """A generator for one purpose (``stream``) and item (``index``) of a
    run's ``seed``; any whole number is a seed."""
    return np.random.default_rng([int(seed) % 2**64, stream, index])


def _rotation(axis, angle):
    axis = axis / np.linalg.norm(axis)
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * kx @ kx


def make_view(rng, n_edgels, k_mat, depth=1000.0):
    """One random scene (the original's geometry): returns (edgels (N, 12)
    float64 rows of (x, y, tx, ty) per view, {2: (R, t), 3: (R, t)})."""
    centre = np.array([0.0, 0.0, depth])
    poses = {}
    for v in (2, 3):
        axis = rng.standard_normal(3)
        axis[2] *= 0.3  # mostly orbit about the object, little roll
        r = _rotation(axis, rng.uniform(np.deg2rad(8), np.deg2rad(25)))
        t = np.array([0.0, 0.0, depth]) - r @ centre
        t += rng.standard_normal(3) * np.array([20.0, 20.0, 50.0])
        poses[v] = (r, t)
    half = 0.06 * depth  # object radius: stays inside every view
    rows = []
    have = 0
    while have < n_edgels:
        m = 2 * (n_edgels - have) + 64
        pw = centre + rng.uniform(-half, half, (m, 3))
        dw = rng.standard_normal((m, 3))
        dw /= np.linalg.norm(dw, axis=1, keepdims=True)
        ok = np.ones(m, dtype=bool)
        cols = []
        for v in (1, 2, 3):
            r, t = (np.eye(3), np.zeros(3)) if v == 1 else poses[v]
            pc = pw @ r.T + t
            dc = dw @ r.T
            g = pc / pc[:, 2:3]
            tan = dc[:, :2] - g[:, :2] * dc[:, 2:3]
            nrm = np.linalg.norm(tan, axis=1)
            pix = g @ k_mat.T
            ok &= (nrm >= 1e-3) & (pix[:, 0] > 0) & (pix[:, 0] < 500) \
                & (pix[:, 1] > 0) & (pix[:, 1] < 560)
            cols.append(np.concatenate(
                [g[:, :2], tan / np.maximum(nrm, 1e-300)[:, None]], axis=1))
        block = np.concatenate(cols, axis=1)[ok]
        rows.append(block[:n_edgels - have])
        have += len(rows[-1])
    return np.concatenate(rows), poses


def mismatch(rng, edgels: np.ndarray, share: float):
    """Give exactly round(share x N) rows, drawn from rng, the view-2 and
    view-3 entries (columns 4-11) of another row, drawn from rng among the
    original rows.  Returns (edgels, the mismatched rows' mask)."""
    n = len(edgels)
    m = int(round(share * n))
    rows = rng.choice(n, size=m, replace=False)
    src = (rows + 1 + rng.integers(0, n - 1, size=m)) % n  # never the row
    out = edgels.copy()
    out[rows, 4:12] = edgels[src, 4:12]
    mask = np.zeros(n, dtype=bool)
    mask[rows] = True
    return out, mask


def make_pool(traffic: dict, seed: int, k_mat: np.ndarray) -> list:
    """The traffic file's pool of views for ``seed``: view i from its own
    generator, so a pool's views do not depend on its size."""
    pool = []
    for i in range(int(traffic["pool_views"])):
        rng = rng_for(seed, VIEW_STREAM, i)
        edgels, poses = make_view(rng, int(traffic["edgels_per_view"]),
                                  k_mat, float(traffic["depth"]))
        edgels, mask = mismatch(rng, edgels,
                                float(traffic["mismatch_share"]))
        e = edgels.astype(np.float32)
        pool.append(View(
            edge_locations=np.ascontiguousarray(e[:, [0, 1, 4, 5, 8, 9]]),
            edge_tangents=np.ascontiguousarray(e[:, [2, 3, 6, 7, 10, 11]]),
            pose21=poses[2], pose31=poses[3], mismatched=mask))
    return pool


def request_seed(seed: int, i: int, stream: int = SAMPLE_STREAM) -> int:
    """The RANSAC sampling seed of request i of a run (a 63-bit draw of its
    own, so that the requests of a run sample their hypotheses apart); the
    warm-up round's with ``WARMUP_STREAM``."""
    return int(rng_for(seed, stream, i).integers(0, 2**63))
