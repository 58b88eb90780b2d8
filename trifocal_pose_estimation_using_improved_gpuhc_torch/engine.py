"""One RANSAC round of trifocal pose estimation over HC path tracking.

Counterpart of the JAX package's ``engine.py`` (its non-abort
``run_round``): sample edgel triplets, build target parameters, track
num_tracks x H paths in one tracker call, score the converged candidates
on the device, pick the best-supported pose and measure its residuals
against ground truth.  The device is explicit: the engine runs where
``device`` says and never moves work elsewhere.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import data_io
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import evaluation as evl
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused, ransac
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
    EngineConfig,
    check_shipped,
    ransac_data_dir,
)

_SCORE_CHUNK = 1024  # paths per scoring chunk: bounds the (paths x edgels) block


@dataclasses.dataclass
class RoundResult:
    """One RANSAC round on one view triplet."""

    stats: evl.SolutionStats
    track_ms: float          # tracker launch + synchronise
    total_ms: float          # tracking + scoring + selection
    num_candidates: int
    best_support21: int
    best_support31: int
    num_edgels: int
    found_pose: bool          # >= 0.9 support on both pairs
    pose_errors: Optional[evl.PoseErrors]
    best_pose: Optional[tuple]  # (R21, R31, t21, t31) numpy
    num_steps: np.ndarray     # per-path HC step counts
    # HC step counts of the max-support solutions (union over both pairs).
    actual_sol_steps: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32)
    )
    # Per-path outcomes, for cross-checks against the reference.
    converged: Optional[np.ndarray] = None
    inf_fail: Optional[np.ndarray] = None
    pruned: Optional[np.ndarray] = None


class TrifocalPoseEngine:
    def __init__(self, cfg: EngineConfig, device="cpu", track_fn=None):
        check_shipped(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.problem = trifocal.TrifocalProblem.load(cfg)
        self.track = track_fn or fused.make_track_fn(self.problem, cfg.hc)
        self._intrinsics = data_io.load_intrinsic_matrix(ransac_data_dir(cfg))
        self._k = torch.as_tensor(self._intrinsics, device=self.device)
        self._start = torch.as_tensor(self.problem.start_sols,
                                      device=self.device)

    def load_view(self, view_index: int) -> data_io.RansacView:
        return data_io.load_ransac_view(ransac_data_dir(self.cfg), view_index)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _device_score(self, res: fused.TrackResult, edgels: torch.Tensor):
        """Real-solution and candidate masks and per-path supports (-1 for
        non-candidates), scored in chunks of _SCORE_CHUNK paths."""
        rc = self.cfg.ransac
        x = res.x
        xr, xi = x.real, x.imag
        conv = res.converged
        real = conv & (xi.abs() <= rc.zero_imag_part_tol).all(dim=1)
        cand = (conv & (xi[:, 24:30].abs() < rc.imag_part_tol).all(dim=1)
                & (xr[:, 0:8] >= 0).all(dim=1))
        n21 = torch.full_like(conv, -1, dtype=torch.int32)
        n31 = torch.full_like(n21, -1)
        for lo in range(0, x.shape[0], _SCORE_CHUNK):
            hi = min(lo + _SCORE_CHUNK, x.shape[0])
            r21, r31, t21, t31 = trifocal.solution_to_pose(xr[lo:hi])
            a, b = ransac.count_inlier_support(
                r21, r31, t21, t31, edgels, self._k,
                thresh_px=rc.reproj_inlier_thresh_px)
            c = cand[lo:hi]
            n21[lo:hi] = torch.where(c, a.to(torch.int32), -1)
            n31[lo:hi] = torch.where(c, b.to(torch.int32), -1)
        return real, cand, n21, n31

    def _post_from_support(self, view, n21, n31, num_steps, x, counts):
        """Host tail: best-pose selection + GT residuals.  x: the tracked
        solutions (on the device), of which only the best row is read."""
        n_edgels = view.edge_locations.shape[0]
        num_conv, num_inf, num_real, n_cand = counts
        stats = evl.SolutionStats(
            num_converged=num_conv, num_infinity=num_inf,
            num_real=num_real, num_paths=len(n21),
        )
        best21 = best31 = 0
        found = False
        pose_errors = None
        best_pose = None
        actual_steps = np.zeros(0, np.int32)
        if n_cand:
            bi = int(np.argmax(np.minimum(n21, n31)))
            best21, best31 = int(n21[bi]), int(n31[bi])
            ratio = self.cfg.ransac.pass_inlier_support_ratio
            found = (best21 >= ratio * n_edgels
                     and best31 >= ratio * n_edgels)
            best_pose = tuple(
                a.cpu().numpy() for a in trifocal.solution_to_pose(x[bi]))
            pose_errors = evl.measure_pose_error(
                *best_pose, view.gt_pose21, view.gt_pose31
            )
            actual = np.union1d(
                np.nonzero(n21 == n21.max())[0],
                np.nonzero(n31 == n31.max())[0],
            )
            actual_steps = num_steps[actual].astype(np.int32)
        return (stats, best21, best31, found, best_pose, pose_errors,
                actual_steps)

    def run_round(self, view: data_io.RansacView, seed: int,
                  num_hypotheses: Optional[int] = None) -> RoundResult:
        cfg = self.cfg
        H = num_hypotheses or cfg.ransac.num_iterations
        T = self.problem.num_tracks
        n_edgels = view.edge_locations.shape[0]
        dev = self.device

        samples = ransac.sample_edgel_triplets(seed, n_edgels, H)
        tgt = ransac.build_target_params(
            view.edge_locations, view.edge_tangents, samples)
        # Staging sits outside the timed span, as in the reference.
        tgt_d = torch.as_tensor(tgt, device=dev).repeat_interleave(T, dim=0)
        x0 = self._start.repeat(H, 1)
        edgels = torch.as_tensor(view.edge_locations, device=dev)
        self._sync()

        t_start = time.perf_counter()
        res = self.track(x0, tgt_d)
        self._sync()
        t_track = time.perf_counter()
        real, cand, n21, n31 = self._device_score(res, edgels)
        packed = torch.stack([res.converged.to(torch.int32),
                              res.inf_fail.to(torch.int32),
                              real.to(torch.int32), cand.to(torch.int32),
                              n21, n31, res.num_steps,
                              res.pruned.to(torch.int32)]).cpu().numpy()
        conv_m, inf_m, real_m, cand_m = (packed[i].astype(bool)
                                         for i in range(4))
        n21_h, n31_h, num_steps = packed[4], packed[5], packed[6]
        counts = (int(conv_m.sum()), int(inf_m.sum()),
                  int(real_m.sum()), int(cand_m.sum()))
        (stats, best21, best31, found, best_pose, pose_errors,
         actual_steps) = self._post_from_support(
            view, n21_h, n31_h, num_steps, res.x, counts)
        t_end = time.perf_counter()
        return RoundResult(
            stats=stats,
            track_ms=(t_track - t_start) * 1e3,
            total_ms=(t_end - t_start) * 1e3,
            num_candidates=counts[3],
            best_support21=best21,
            best_support31=best31,
            num_edgels=n_edgels,
            found_pose=found,
            pose_errors=pose_errors,
            best_pose=best_pose,
            num_steps=num_steps,
            actual_sol_steps=actual_steps,
            converged=conv_m,
            inf_fail=inf_m,
            pruned=packed[7].astype(bool),
        )
