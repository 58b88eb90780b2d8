"""Host-side evaluation: solution statistics, unique solutions, pose
residuals against ground truth, and the reference-format output writers
(numpy).

Counterpart of the JAX package's ``utils/evaluation.py``: the same
functions, and the same bytes in every file the writers produce.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
    RansacConfig,
)


@dataclasses.dataclass
class SolutionStats:
    """Per-round solution statistics; num_unique is -1 when no dedup pass
    ran."""

    num_converged: int
    num_infinity: int
    num_real: int
    num_paths: int
    num_unique: int = -1

    @property
    def pct_converged(self) -> float:
        return self.num_converged / max(self.num_paths, 1)

    @property
    def pct_infinity(self) -> float:
        return self.num_infinity / max(self.num_paths, 1)

    @property
    def pct_real(self) -> float:
        return self.num_real / max(self.num_paths, 1)

    @property
    def pct_unique(self) -> float:
        return max(self.num_unique, 0) / max(self.num_paths, 1)


def collect_stats(
    x: np.ndarray,
    converged: np.ndarray,
    inf_fail: np.ndarray,
    ransac: RansacConfig,
) -> SolutionStats:
    """Converged, diverged and real solutions over the whole batch; a
    solution is real when converged and every variable's imaginary part is
    within zero_imag_part_tol."""
    real = converged & (np.abs(x.imag) <= ransac.zero_imag_part_tol).all(axis=-1)
    return SolutionStats(
        num_converged=int(converged.sum()),
        num_infinity=int(inf_fail.sum()),
        num_real=int(real.sum()),
        num_paths=int(x.shape[0]),
    )


def find_unique_solutions(
    x: np.ndarray, converged: np.ndarray, tol: float = 1e-4
) -> np.ndarray:
    """Indices of the unique converged solutions: two are duplicates when
    every variable agrees within tol in both real and imaginary parts."""
    idx = np.nonzero(converged)[0]
    if idx.size == 0:
        return idx
    xs = x[idx]
    keep = []
    taken = np.zeros(len(idx), dtype=bool)
    for i in range(len(idx)):
        if taken[i]:
            continue
        keep.append(idx[i])
        d = np.abs(xs.real - xs.real[i]) < tol
        d &= np.abs(xs.imag - xs.imag[i]) < tol
        taken |= d.all(axis=-1)
    return np.asarray(keep)


def find_unique_solutions_reference(
    x: np.ndarray, converged: np.ndarray, num_tracks: int, tol: float = 1e-4
) -> np.ndarray:
    """The reference's unique-solution count, quirks kept: only RANSAC
    iteration 0 (the first num_tracks paths) is scanned; each converged
    solution is compared with every later path, converged or not; and the
    skip set is replaced by the latest duplicate set, not accumulated, so
    a duplicate of an earlier solution can count as unique later."""
    n = min(num_tracks, x.shape[0])
    keep = []
    skip: set = set()
    for bs in range(n):
        if not converged[bs]:
            continue
        if skip and bs in skip:
            continue
        d = np.abs(x[bs + 1:n].real - x[bs].real) < tol
        d &= np.abs(x[bs + 1:n].imag - x[bs].imag) < tol
        dup = np.nonzero(d.all(axis=-1))[0] + bs + 1
        if dup.size == 0:
            keep.append(bs)
        else:
            skip = set(int(i) for i in dup)
    return np.asarray(keep, dtype=np.int64)


def min_residuals_over_sols(
    r21s: np.ndarray,
    r31s: np.ndarray,
    t21s: np.ndarray,
    t31s: np.ndarray,
    gt_pose21: np.ndarray,
    gt_pose31: np.ndarray,
    ransac: RansacConfig,
) -> Tuple["PoseErrors", bool]:
    """Each residual minimised on its own over the candidate poses, and
    whether any one pose has all four within tolerance.  No candidate
    gives residuals of 100 and False."""
    gr21, gt21u = decompose_gt_pose(gt_pose21)
    gr31, gt31u = decompose_gt_pose(gt_pose31)
    if len(r21s) == 0:
        return PoseErrors(100.0, 100.0, 100.0, 100.0), False
    rr21 = rotation_residual(gr21, r21s)
    rr31 = rotation_residual(gr31, r31s)
    tt21 = translation_residual(gt21u, t21s)
    tt31 = translation_residual(gt31u, t31s)
    success = bool(np.any(
        (rr21 < ransac.rot_residual_tol)
        & (rr31 < ransac.rot_residual_tol)
        & (tt21 < ransac.transl_residual_tol)
        & (tt31 < ransac.transl_residual_tol)
    ))
    return (
        PoseErrors(
            rot21=float(rr21.min()), rot31=float(rr31.min()),
            transl21=float(tt21.min()), transl31=float(tt31.min()),
        ),
        success,
    )


@dataclasses.dataclass
class PoseErrors:
    rot21: float
    rot31: float
    transl21: float
    transl31: float

    def within(self, ransac: RansacConfig) -> bool:
        return (
            self.rot21 < ransac.rot_residual_tol
            and self.rot31 < ransac.rot_residual_tol
            and self.transl21 < ransac.transl_residual_tol
            and self.transl31 < ransac.transl_residual_tol
        )


def rotation_residual(r_gt: np.ndarray, r: np.ndarray) -> np.ndarray:
    """acos((trace(R_gt^T R) - 1) / 2), broadcast over leading dims."""
    tr = np.einsum("ij,...ij->...", r_gt, r)
    return np.arccos(np.clip(0.5 * (tr - 1.0), -1.0, 1.0))


def translation_residual(t_gt_unit: np.ndarray, t: np.ndarray) -> np.ndarray:
    """|<t_gt, t/|t|> - 1|, both unit-normalised."""
    tn = t / np.linalg.norm(t, axis=-1, keepdims=True)
    return np.abs(tn @ t_gt_unit - 1.0)


def decompose_gt_pose(pose: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(3, 4) [R | t] -> (R, unit t)."""
    r = pose[:, :3]
    t = pose[:, 3]
    return r, t / np.linalg.norm(t)


def measure_pose_error(
    r21: np.ndarray,
    r31: np.ndarray,
    t21: np.ndarray,
    t31: np.ndarray,
    gt_pose21: np.ndarray,
    gt_pose31: np.ndarray,
) -> PoseErrors:
    """Residuals of one estimated trifocal pose against ground truth."""
    gr21, gt21 = decompose_gt_pose(gt_pose21)
    gr31, gt31 = decompose_gt_pose(gt_pose31)
    return PoseErrors(
        rot21=float(rotation_residual(gr21, r21)),
        rot31=float(rotation_residual(gr31, r31)),
        transl21=float(translation_residual(gt21, t21)),
        transl31=float(translation_residual(gt31, t31)),
    )


def format_gt_deviation(
    r21: np.ndarray,
    r31: np.ndarray,
    t21: np.ndarray,
    t31: np.ndarray,
    gt_pose21: np.ndarray,
    gt_pose31: np.ndarray,
) -> str:
    """The ground-truth deviation report of one pose: the unit ground-truth
    and solution translations side by side, then the four residuals."""
    _, gt21 = decompose_gt_pose(gt_pose21)
    _, gt31 = decompose_gt_pose(gt_pose31)
    n21 = t21 / np.linalg.norm(t21)
    n31 = t31 / np.linalg.norm(t31)
    pe = measure_pose_error(r21, r31, t21, t31, gt_pose21, gt_pose31)

    def v(x):
        return f"({x[0]:.6g}, {x[1]:.6g}, {x[2]:.6g})"

    return (
        f"GT translation_21 = {v(gt21)}\n"
        f"GT translation_31 = {v(gt31)}\n"
        f"Sol translation_21 = {v(n21)}\n"
        f"Sol translation_31 = {v(n31)}\n"
        f"Residuals in Rotations:    (R21) {pe.rot21:.6g} "
        f"(R31) {pe.rot31:.6g}\n"
        f"Residuals in Translations: (t21) {pe.transl21:.6g} "
        f"(t31) {pe.transl31:.6g}"
    )


# The reference's output files.

def write_timings(path: str, timings_ms: Sequence[float]) -> None:
    """GPU_Timings.txt: one round's milliseconds per line."""
    with open(path, "w") as f:
        for t in timings_ms:
            f.write(f"{t}\n")


def write_sols_statistics(path: str, stats: Sequence[SolutionStats]) -> None:
    """*_Sols_Statistics.txt: converged, infinity and real per round, tab
    separated (in that order; the reference swaps the last two when it
    collects them, which is not copied)."""
    with open(path, "w") as f:
        for s in stats:
            f.write(f"{s.num_converged}\t{s.num_infinity}\t{s.num_real}\n")


def write_converged_sols(
    path: str,
    x: np.ndarray,
    converged: np.ndarray,
    num_tracks: int,
) -> None:
    """*_Converged_HC_tracks.txt: per RANSAC iteration, each converged
    path's index and its variables (real and imaginary part per line)."""
    num_vars = x.shape[1]
    n_ransac = x.shape[0] // num_tracks
    counter = 0
    with open(path, "w") as f:
        for ri in range(n_ransac):
            f.write(f"-------------------- RANSAC Iteration {ri + 1} "
                    f"--------------------\n\n")
            for bs in range(num_tracks):
                i = ri * num_tracks + bs
                if converged[i]:
                    f.write(f"{counter}\n")
                    for v in range(num_vars):
                        f.write(f"{x[i, v].real:.20g}\t{x[i, v].imag:.20g}\n")
                    f.write("\n")
                counter += 1
            f.write("\n")


def write_hc_steps(path: str, steps: Sequence[int]) -> None:
    """*HC_Steps_of_Actual_Solutions.txt: the HC step counts of the
    max-support solutions, one per line."""
    with open(path, "w") as f:
        for s in steps:
            f.write(f"{int(s)}\n")


def timing_summary(timings_ms: Sequence[float]) -> dict:
    """Mean, maximum, minimum and standard deviation of round times."""
    a = np.asarray(timings_ms, dtype=np.float64)
    return {
        "avg_ms": float(a.mean()),
        "max_ms": float(a.max()),
        "min_ms": float(a.min()),
        "std_ms": float(a.std()),
    }
