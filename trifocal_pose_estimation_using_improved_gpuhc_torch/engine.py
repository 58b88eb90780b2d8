"""One RANSAC round of trifocal pose estimation over HC path tracking.

Counterpart of the JAX package's ``engine.py`` (``run_round``): sample
edgel triplets, build target parameters, track num_tracks x H paths,
score the converged candidates on the device, pick the best-supported
pose and measure its residuals against ground truth.  The tracker is the
JAX engine's choice: the segmented one (``ops/segmented.py``) when survivor
compaction or the TrunRANSAC abort is on, else one call over the whole
budget (``ops/fused.py``).  With ``abort_by_good_sol`` the round tracks
the hypotheses in chunks and stops at the first chunk that finds a pose.

The engine runs on the card (``cuda:0``) unless the caller asks for
another device, and never moves work elsewhere.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    fused,
    ransac,
    segmented,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import data_io
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import evaluation as evl
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
    track_ms: float          # tracking to the decision, synchronised
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
    # Abort rounds: the chunks tracked before the round stopped.
    chunks_run: int = 1


class TrifocalPoseEngine:
    def __init__(self, cfg: EngineConfig, device=None, track_fn=None):
        """device: None means the first CUDA card, and raises without one.
        track_fn: a one-call tracker ``(x0, target_params) -> TrackResult``
        in place of the configured one (the abort round needs the
        segmented tracker, so it refuses one)."""
        check_shipped(cfg)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device; pass device='cpu' to run on the CPU")
            device = "cuda:0"
        self.cfg = cfg
        self.device = torch.device(device)
        self.problem = trifocal.TrifocalProblem.load(cfg)
        self._abort = cfg.ransac.abort_by_good_sol
        self._segmented = track_fn is None and (
            cfg.hc.compact_survivors or self._abort)
        if track_fn is not None and self._abort:
            raise ValueError("the abort round runs the segmented tracker")
        if track_fn is not None:
            self.track = track_fn
        elif self._segmented:
            self.track = segmented.make_segmented_track_fn(
                self.problem, cfg.hc, cfg.ransac)
        else:
            self.track = fused.make_track_fn(self.problem, cfg.hc)
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

    def _post_from_support(self, view, n21, n31, num_steps, best_x, counts):
        """Host tail: best-pose selection + GT residuals.  best_x(i): path
        i's solution on the device; only the best row is read."""
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
                a.cpu().numpy() for a in trifocal.solution_to_pose(best_x(bi)))
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
        dev = self.device

        samples = ransac.sample_edgel_triplets(
            seed, view.edge_locations.shape[0], H)
        tgt = ransac.build_target_params(
            view.edge_locations, view.edge_tangents, samples)
        edgels = torch.as_tensor(view.edge_locations, device=dev)
        if self._abort:
            return self._abort_round(view, tgt, edgels)
        # Staging sits outside the timed span, as in the reference.
        tgt_d = torch.as_tensor(tgt, device=dev).repeat_interleave(T, dim=0)
        x0 = self._start.repeat(H, 1)
        self._sync()

        t_start = time.perf_counter()
        res = self.track(x0, tgt_d)
        if self._segmented:
            res = res.track
        self._sync()
        t_track = time.perf_counter()
        packed = self._score_pack(res, edgels).cpu().numpy()
        return self._finish(view, packed, lambda bi: res.x[bi], t_start,
                            t_track)

    def _abort_round(self, view, tgt: np.ndarray,
                     edgels: torch.Tensor) -> RoundResult:
        """TrunRANSAC: the hypotheses in chunks of abort_chunk, stopping at
        the first chunk whose tracking found a pose (engine.py:401-534 of
        the JAX package).  The reference dispatches chunk i+1 before it
        reads chunk i's found flag, to hide that read behind the next
        chunk.  Here the segment loop has already read the flag at chunk
        i's last boundary, so nothing is left to hide: chunk i+1 starts only
        when chunk i found nothing.  Chunks never run are scored as having
        no candidates."""
        cfg = self.cfg
        H, T, dev = len(tgt), self.problem.num_tracks, self.device
        n_edgels = view.edge_locations.shape[0]
        chunk_h = min(cfg.ransac.abort_chunk, H)
        n_chunks = -(-H // chunk_h)
        x0 = self._start.repeat(chunk_h, 1)
        chunks = []
        for ci in range(n_chunks):
            lo, hi = ci * chunk_h, min((ci + 1) * chunk_h, H)
            # A ragged tail repeats its first hypotheses up to a full chunk;
            # the repeats are sliced away below.
            idx = lo + np.arange(chunk_h) % (hi - lo)
            chunks.append(torch.as_tensor(tgt[idx], device=dev)
                          .repeat_interleave(T, dim=0))
        self._sync()

        t_start = time.perf_counter()
        results = []
        for tg in chunks:
            res = self.track(x0, tg, edgels, self._k, n_edgels)
            results.append(res.track)
            if res.found:
                break
        t_track = time.perf_counter()

        per = chunk_h * T
        packed = torch.cat([self._score_pack(r, edgels) for r in results],
                           dim=1)
        skipped = H * T - packed.shape[1]
        if skipped > 0:  # chunks never run: no candidates
            pad = packed.new_zeros((packed.shape[0], skipped))
            pad[4:6] = -1
            packed = torch.cat([packed, pad], dim=1)
        packed = packed[:, :H * T].cpu().numpy()
        return self._finish(
            view, packed, lambda bi: results[bi // per].x[bi % per],
            t_start, t_track, chunks_run=len(results))

    def _score_pack(self, res: fused.TrackResult,
                    edgels: torch.Tensor) -> torch.Tensor:
        """(8, B) int32 on the device: converged, inf, real, candidate,
        n21, n31, steps, pruned."""
        real, cand, n21, n31 = self._device_score(res, edgels)
        return torch.stack([res.converged.to(torch.int32),
                            res.inf_fail.to(torch.int32),
                            real.to(torch.int32), cand.to(torch.int32),
                            n21, n31, res.num_steps,
                            res.pruned.to(torch.int32)])

    def _finish(self, view, packed: np.ndarray, best_x, t_start: float,
                t_track: float, **chunks) -> RoundResult:
        """The host tail over the packed per-path rows (``_score_pack``);
        best_x(i) is path i's solution on the device."""
        conv_m, inf_m, real_m, cand_m = (packed[i].astype(bool)
                                         for i in range(4))
        n21_h, n31_h, num_steps = packed[4], packed[5], packed[6]
        counts = (int(conv_m.sum()), int(inf_m.sum()),
                  int(real_m.sum()), int(cand_m.sum()))
        (stats, best21, best31, found, best_pose, pose_errors,
         actual_steps) = self._post_from_support(
            view, n21_h, n31_h, num_steps, best_x, counts)
        t_end = time.perf_counter()
        return RoundResult(
            stats=stats,
            track_ms=(t_track - t_start) * 1e3,
            total_ms=(t_end - t_start) * 1e3,
            num_candidates=counts[3],
            best_support21=best21,
            best_support31=best31,
            num_edgels=view.edge_locations.shape[0],
            found_pose=found,
            pose_errors=pose_errors,
            best_pose=best_pose,
            num_steps=num_steps,
            actual_sol_steps=actual_steps,
            converged=conv_m,
            inf_fail=inf_m,
            pruned=packed[7].astype(bool),
            **chunks,
        )
