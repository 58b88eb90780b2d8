# Frozen copy of trifocal_pose_estimation_using_improved_gpuhc_torch/utils/data_io.py at commit e13ae2fbc8b3,
# the benchmark's plain reference: imports rewritten to hcbench.plain.  Never edit it to follow the program.
"""Loaders for the problem start system, the Jacobian index tables and the
synthcurves RANSAC dataset, parsed with numpy.

Counterpart of the JAX package's ``utils/data_io.py``: the same files and
the same arrays.  File formats (all plain whitespace-separated text):

  start_params.txt   one "re im" line per parameter
  start_sols.txt     num_tracks * num_vars lines "re im"
  dHdx_indx.txt      num_vars * hx_terms * hx_parts rows x num_vars ints
  dHdt_indx.txt      ht_terms * ht_parts rows x num_vars ints
  Intrinsic_Matrix.txt            3x3 floats
  GT_Poses21/GT_Poses21_%03d.txt  4 rows x 3: R row-major, then t
  Triplet_Edgels/Triplet_Edgels_%03d.txt  N x 12 floats
       = (x, y, tx, ty) per view, metric coordinates

The Hx table is [var v][term j][part k][eq e] with parts (int coeff,
param, param, var, var); the H/Ht table is [term j][part k][eq e] with
parts (coeff, p1, p2, v1, v2, v3).  Parameter index num_params addresses
a constant-1 slot, variable index num_vars the homogeneous-1 slot.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


def _parse(path: str) -> np.ndarray:
    """Every number of a whitespace-separated text file, as float64."""
    with open(path) as f:
        return np.array(f.read().split(), dtype=np.float64)


def _load_complex(path: str) -> np.ndarray:
    a = _parse(path).reshape(-1, 2)
    return (a[:, 0] + 1j * a[:, 1]).astype(np.complex64)


@dataclasses.dataclass(frozen=True)
class ProblemData:
    """Start system + index tables for one minimal problem."""

    start_params: np.ndarray  # complex64 (num_params,)
    start_sols: np.ndarray    # complex64 (num_tracks, num_vars)
    hx_table: np.ndarray      # int32 (num_vars, hx_terms, hx_parts, num_eqs)
    ht_table: np.ndarray      # int32 (ht_terms, ht_parts, num_eqs)


def load_problem_data(
    problem_dir: str,
    num_vars: int = 30,
    num_tracks: int = 312,
    hx_terms: int = 8,
    hx_parts: int = 5,
    ht_terms: int = 16,
    ht_parts: int = 6,
) -> ProblemData:
    start_params = _load_complex(os.path.join(problem_dir, "start_params.txt"))
    sols = _load_complex(os.path.join(problem_dir, "start_sols.txt"))
    start_sols = sols.reshape(num_tracks, num_vars)
    hx = _parse(os.path.join(problem_dir, "dHdx_indx.txt")).astype(np.int32)
    hx_table = hx.reshape(num_vars, hx_terms, hx_parts, num_vars)
    ht = _parse(os.path.join(problem_dir, "dHdt_indx.txt")).astype(np.int32)
    ht_table = ht.reshape(ht_terms, ht_parts, num_vars)
    return ProblemData(start_params, start_sols, hx_table, ht_table)


@dataclasses.dataclass(frozen=True)
class RansacView:
    """One view-triplet of the RANSAC dataset."""

    edge_locations: np.ndarray  # float32 (N, 6) = (x1,y1,x2,y2,x3,y3) metric
    edge_tangents: np.ndarray   # float32 (N, 6)
    gt_pose21: np.ndarray       # float32 (3, 4) [R | t]
    gt_pose31: np.ndarray       # float32 (3, 4)


def load_intrinsic_matrix(dataset_dir: str) -> np.ndarray:
    k = _parse(os.path.join(dataset_dir, "Intrinsic_Matrix.txt"))
    return k.reshape(3, 3).astype(np.float32)


def load_ransac_view(dataset_dir: str, view_index: int) -> RansacView:
    idx = f"{view_index:03d}"
    edgels = _parse(os.path.join(
        dataset_dir, "Triplet_Edgels", f"Triplet_Edgels_{idx}.txt")
    ).reshape(-1, 12).astype(np.float32)
    # Columns: (x, y, tx, ty) x 3 views -> locations (x, y) x 3, tangents
    # (tx, ty) x 3.
    locations = edgels[:, [0, 1, 4, 5, 8, 9]]
    tangents = edgels[:, [2, 3, 6, 7, 10, 11]]

    def _load_pose(subdir: str, stem: str) -> np.ndarray:
        # 4 rows x 3: R row-major, then t; repacked as (3, 4) [R | t].
        a = _parse(os.path.join(dataset_dir, subdir, f"{stem}_{idx}.txt")
                   ).reshape(4, 3)
        return np.concatenate([a[:3, :], a[3, :][:, None]],
                              axis=1).astype(np.float32)

    return RansacView(locations, tangents,
                      _load_pose("GT_Poses21", "GT_Poses21"),
                      _load_pose("GT_Poses31", "GT_Poses31"))


def num_ransac_views(dataset_dir: str) -> int:
    """The views of a RANSAC dataset: its Triplet_Edgels_* files."""
    d = os.path.join(dataset_dir, "Triplet_Edgels")
    return len([f for f in os.listdir(d) if f.startswith("Triplet_Edgels_")])
