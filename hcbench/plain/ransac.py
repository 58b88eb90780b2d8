# Frozen copy of trifocal_pose_estimation_using_improved_gpuhc_torch/ops/ransac.py at commit e13ae2fbc8b3,
# the benchmark's plain reference: imports rewritten to hcbench.plain.  Never edit it to follow the program.
"""RANSAC: hypothesis sampling, target parameters, inlier scoring.

Counterpart of the JAX package's ``ops/ransac.py``.  Sampling (its own and
the reference's glibc sampler) and target construction are its pure-numpy
functions, re-homed (the reference module imports jax); scoring is torch.

Depth/reprojection math for a correspondence (g1, g2) in metric image
coordinates and a relative pose (R, T):

  rho   = (T_z (R^T g2)_z - (R^T T)_z) / (1 - (R g1)_z (R^T g2)_z)
  p     = rho R g1 + T
  error = || K(p / p_z) - K(g2) ||_px,  inlier iff error < threshold.

The expression is invariant to the scale of T.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def sample_edgel_triplets(
    seed: int, num_edgels: int, num_hypotheses: int
) -> np.ndarray:
    """Pick 3 distinct edgel indices per hypothesis, deterministically
    (numpy's PCG seeded with ``seed``; same seed => same samples)."""
    rng = np.random.default_rng(seed)
    out = np.empty((num_hypotheses, 3), dtype=np.int64)
    for h in range(num_hypotheses):
        while True:
            s = rng.integers(0, num_edgels, size=3)
            if s[0] != s[1] and s[0] != s[2] and s[1] != s[2]:
                break
        out[h] = s
    return out


class GlibcRand:
    """glibc's rand() (the TYPE_3 additive feedback generator: degree 31,
    separation 3) bit for bit, so that the reference's srand(seed)-based
    RANSAC sampling can be reproduced exactly.  A copy of the JAX
    package's ``ops/ransac.GlibcRand``."""

    def __init__(self, seed: int):
        seed = seed if seed != 0 else 1
        r = [0] * 34
        r[0] = seed & 0xFFFFFFFF
        for i in range(1, 31):
            # r[i] = 16807 * r[i-1] % 2147483647 by Schrage's method, as
            # glibc computes it.
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._r = r
        for _ in range(34, 344):  # the first 310 outputs are discarded
            self._next()

    def _next(self) -> int:
        r = self._r
        v = (r[-31] + r[-3]) & 0xFFFFFFFF
        r.append(v)
        if len(r) > 64:
            del r[:-31]
        return v >> 1

    def rand(self) -> int:
        return self._next()


def sample_edgel_triplets_reference(
    seed: int, num_edgels: int, num_hypotheses: int
) -> np.ndarray:
    """The reference's own sampling: glibc srand(seed) and rand() % N,
    with its duplicate check that never compares indices 0 and 2 (so
    e0 == e2 passes).  For reconciling counts with the reference's
    committed sample runs (``tools/reconcile_stats_torch.py``); the
    engine samples with ``sample_edgel_triplets``."""
    rng = GlibcRand(seed)
    out = np.empty((num_hypotheses, 3), dtype=np.int64)
    for h in range(num_hypotheses):
        while True:
            s = [rng.rand() % num_edgels for _ in range(3)]
            if s[0] != s[1] and s[1] != s[2]:  # e0 == e2 passes
                break
        out[h] = s
    return out


def build_target_params(
    edge_locations: np.ndarray,
    edge_tangents: np.ndarray,
    samples: np.ndarray,
) -> np.ndarray:
    """Triplet edgels -> target parameters, (H, 34) complex64.

    params[0:18] = locations of the 3 sampled edgels (6 each),
    params[18:30] = tangents of the first 2, params[30:33] = the gauge
    constants (1.0, 0.5, 1.0), params[33] = 1 (constant slot)."""
    H = samples.shape[0]
    tgt = np.zeros((H, 34), dtype=np.complex64)
    tgt[:, 0:6] = edge_locations[samples[:, 0]]
    tgt[:, 6:12] = edge_locations[samples[:, 1]]
    tgt[:, 12:18] = edge_locations[samples[:, 2]]
    tgt[:, 18:24] = edge_tangents[samples[:, 0]]
    tgt[:, 24:30] = edge_tangents[samples[:, 1]]
    tgt[:, 30] = 1.0
    tgt[:, 31] = 0.5
    tgt[:, 32] = 1.0
    tgt[:, 33] = 1.0
    return tgt


def _pair_inliers(
    r: torch.Tensor,   # (S, 3, 3)
    t: torch.Tensor,   # (S, 3)
    g1: torch.Tensor,  # (N, 2) metric coords in view 1
    g2: torch.Tensor,  # (N, 2) metric coords in the other view
    k: torch.Tensor,   # (3, 3) intrinsics
    thresh_px: float,
) -> torch.Tensor:
    """Inlier counts (S,) for one view pair."""
    x1, y1 = g1[None, :, 0], g1[None, :, 1]
    x2, y2 = g2[None, :, 0], g2[None, :, 1]
    rtg2 = r[:, 0, 2, None] * x2 + r[:, 1, 2, None] * y2 + r[:, 2, 2, None]
    rtt = r[:, 0, 2] * t[:, 0] + r[:, 1, 2] * t[:, 1] + r[:, 2, 2] * t[:, 2]
    rho_num = t[:, 2, None] * rtg2 - rtt[:, None]
    rg1_z = r[:, 2, 0, None] * x1 + r[:, 2, 1, None] * y1 + r[:, 2, 2, None]
    rho_den = 1.0 - rg1_z * rtg2
    rg1_x = r[:, 0, 0, None] * x1 + r[:, 0, 1, None] * y1 + r[:, 0, 2, None]
    rg1_y = r[:, 1, 0, None] * x1 + r[:, 1, 1, None] * y1 + r[:, 1, 2, None]
    pz = rho_num * rg1_z + rho_den * t[:, 2, None]
    px = (rho_num * rg1_x + rho_den * t[:, 0, None]) / pz
    py = (rho_num * rg1_y + rho_den * t[:, 1, None]) / pz
    ex = (px - x2) * k[0, 0]
    ey = (py - y2) * k[1, 1]
    err = torch.sqrt(ex * ex + ey * ey)
    return torch.sum(err < thresh_px, dim=1)


def count_inlier_support(
    r21: torch.Tensor,
    r31: torch.Tensor,
    t21: torch.Tensor,
    t31: torch.Tensor,
    edge_locations: torch.Tensor,  # (N, 6)
    intrinsics: torch.Tensor,      # (3, 3)
    thresh_px: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reprojection-inlier counts for both view pairs, (S,) each."""
    g1 = edge_locations[:, 0:2]
    g2 = edge_locations[:, 2:4]
    g3 = edge_locations[:, 4:6]
    n21 = _pair_inliers(r21, t21, g1, g2, intrinsics, thresh_px)
    n31 = _pair_inliers(r31, t31, g1, g3, intrinsics, thresh_px)
    return n21, n31
