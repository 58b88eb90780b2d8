"""Host-side evaluation: solution statistics and pose residuals against
ground truth (numpy).

Counterpart of the part of the JAX package's ``utils/evaluation.py`` that
the engine uses; the output writers come with the command-line interface.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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
