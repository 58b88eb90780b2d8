# Frozen copy of trifocal_pose_estimation_using_improved_gpuhc_torch/models/trifocal.py at commit e13ae2fbc8b3,
# the benchmark's plain reference: imports rewritten to hcbench.plain.  Never edit it to follow the program.
"""The trifocal 2op1p problem: index tables compiled to factored form.

Counterpart of the JAX package's ``models/trifocal.py``.  ``_factor_tables``
is the same pure-numpy compiler (re-homed here because the reference module
imports jax); the device helpers are torch:

  H(x, t)  = C3^T . (P(t)_q * X3_m)        K3 distinct (param-pair, var-triple)
  Ht(x, t) = C3^T . (P'(t)_q * X3_m)
  Hx(x, t) = scatter(C2^T . (P(t)_q * X2_m))

Solution layout: x[0:8] depths, x[18:21] T21, x[21:24] T31, x[24:27]
Cayley(R21), x[27:30] Cayley(R31); var index 30 = homogeneous 1; param
index 33 = constant 1.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from hcbench.plain import data_io
from hcbench.plain.config import (
    EngineConfig,
    problem_config,
    problem_dir,
)

DEPTH_SLICE = slice(0, 8)
T21_SLICE = slice(18, 21)
T31_SLICE = slice(21, 24)
CAY21_SLICE = slice(24, 27)
CAY31_SLICE = slice(27, 30)


@dataclasses.dataclass(frozen=True)
class FactoredSystem:
    """Monomial-factored evaluation structure (numpy, device-agnostic)."""

    qm_a: np.ndarray        # int32 (M2,) quadratic monomials x[a] x[b]
    qm_b: np.ndarray
    cm_a: np.ndarray        # int32 (M3,) cubic monomials x[a] x[b] x[c]
    cm_b: np.ndarray
    cm_c: np.ndarray
    pp_a: np.ndarray        # int32 (Q,) parameter pairs p[a] p[b]
    pp_b: np.ndarray
    hx_q: np.ndarray        # int32 (K2,) Hx combos: pair index
    hx_m: np.ndarray        # int32 (K2,) Hx combos: quadratic monomial index
    hx_C: np.ndarray        # float32 (K2, NNZ) combo -> Hx nonzero weights
    hx_scatter: np.ndarray  # int32 (n*n,) flat (eq, var) -> nnz slot or NNZ
    ht_q: np.ndarray        # int32 (K3,)
    ht_m: np.ndarray        # int32 (K3,)
    ht_C: np.ndarray        # float32 (K3, n) combo -> equation weights


def _factor_tables(hx_table: np.ndarray, ht_table: np.ndarray) -> FactoredSystem:
    n_vars = hx_table.shape[0]
    n_eqs = hx_table.shape[-1]

    c = hx_table[:, :, 0, :].astype(np.int64)   # (v, j, e)
    p1 = hx_table[:, :, 1, :]
    p2 = hx_table[:, :, 2, :]
    v1 = hx_table[:, :, 3, :]
    v2 = hx_table[:, :, 4, :]
    nz = np.nonzero(c)
    terms = np.stack(
        [
            c[nz],
            np.minimum(p1[nz], p2[nz]),
            np.maximum(p1[nz], p2[nz]),
            np.minimum(v1[nz], v2[nz]),
            np.maximum(v1[nz], v2[nz]),
            nz[2] * n_vars + nz[0],  # flat Hx entry index: eq * n_vars + var
        ],
        axis=1,
    )

    ct = ht_table[:, 0, :].astype(np.int64)
    tp1 = ht_table[:, 1, :]
    tp2 = ht_table[:, 2, :]
    tv = np.sort(ht_table[:, 3:6, :], axis=1)  # canonicalise the triple
    nzt = np.nonzero(ct)
    terms_t = np.stack(
        [
            ct[nzt],
            np.minimum(tp1[nzt], tp2[nzt]),
            np.maximum(tp1[nzt], tp2[nzt]),
            tv[:, 0, :][nzt],
            tv[:, 1, :][nzt],
            tv[:, 2, :][nzt],
            nzt[1],  # equation index
        ],
        axis=1,
    )

    pairs = np.unique(
        np.concatenate([terms[:, 1:3], terms_t[:, 1:3]], axis=0), axis=0
    )
    pair_lut = {tuple(p): i for i, p in enumerate(pairs)}
    qms = np.unique(terms[:, 3:5], axis=0)
    qm_lut = {tuple(m): i for i, m in enumerate(qms)}
    cms = np.unique(terms_t[:, 3:6], axis=0)
    cm_lut = {tuple(m): i for i, m in enumerate(cms)}

    combo_lut: dict = {}
    entry_lut: dict = {}
    combo_rows = []
    for coeff, pa, pb, va, vb, entry in terms:
        key = (pair_lut[(pa, pb)], qm_lut[(va, vb)])
        k = combo_lut.setdefault(key, len(combo_lut))
        e = entry_lut.setdefault(entry, len(entry_lut))
        combo_rows.append((k, e, coeff))
    K2, NNZ = len(combo_lut), len(entry_lut)
    hx_C = np.zeros((K2, NNZ), dtype=np.float32)
    for k, e, coeff in combo_rows:
        hx_C[k, e] += coeff
    combos = sorted(combo_lut.items(), key=lambda kv: kv[1])
    hx_q = np.array([q for (q, _), _ in combos], dtype=np.int32)
    hx_m = np.array([m for (_, m), _ in combos], dtype=np.int32)
    hx_scatter = np.full((n_eqs * n_vars,), NNZ, dtype=np.int32)
    for entry, e in entry_lut.items():
        hx_scatter[entry] = e

    combo_lut_t: dict = {}
    rows_t = []
    for coeff, pa, pb, va, vb, vc, eq in terms_t:
        key = (pair_lut[(pa, pb)], cm_lut[(va, vb, vc)])
        k = combo_lut_t.setdefault(key, len(combo_lut_t))
        rows_t.append((k, eq, coeff))
    K3 = len(combo_lut_t)
    ht_C = np.zeros((K3, n_eqs), dtype=np.float32)
    for k, eq, coeff in rows_t:
        ht_C[k, eq] += coeff
    combos_t = sorted(combo_lut_t.items(), key=lambda kv: kv[1])
    ht_q = np.array([q for (q, _), _ in combos_t], dtype=np.int32)
    ht_m = np.array([m for (_, m), _ in combos_t], dtype=np.int32)

    return FactoredSystem(
        qm_a=qms[:, 0].astype(np.int32),
        qm_b=qms[:, 1].astype(np.int32),
        cm_a=cms[:, 0].astype(np.int32),
        cm_b=cms[:, 1].astype(np.int32),
        cm_c=cms[:, 2].astype(np.int32),
        pp_a=pairs[:, 0].astype(np.int32),
        pp_b=pairs[:, 1].astype(np.int32),
        hx_q=hx_q,
        hx_m=hx_m,
        hx_C=hx_C,
        hx_scatter=hx_scatter,
        ht_q=ht_q,
        ht_m=ht_m,
        ht_C=ht_C,
    )


@dataclasses.dataclass(frozen=True)
class TrifocalProblem:
    """Host constants of the problem (numpy; moved to a device per call)."""

    num_vars: int
    num_params: int
    num_tracks: int
    start_params: np.ndarray  # complex64 (num_params + 1,) with constant-1 slot
    start_sols: np.ndarray    # complex64 (num_tracks, num_vars)
    hx_table: np.ndarray      # int32 (v, j, 5, e)
    ht_table: np.ndarray      # int32 (j, 6, e)
    factored: FactoredSystem

    @classmethod
    def load(cls, cfg: EngineConfig) -> "TrifocalProblem":
        prob = problem_config(cfg)
        pd = data_io.load_problem_data(
            problem_dir(cfg),
            num_vars=prob.num_vars,
            num_tracks=prob.num_tracks,
            hx_terms=prob.hx_max_terms,
            hx_parts=prob.hx_max_parts,
            ht_terms=prob.ht_max_terms,
            ht_parts=prob.ht_max_parts,
        )
        start_params = np.concatenate(
            [pd.start_params, np.ones((1,), np.complex64)]
        )
        return cls(
            num_vars=prob.num_vars,
            num_params=prob.num_params,
            num_tracks=prob.num_tracks,
            start_params=start_params.astype(np.complex64),
            start_sols=np.asarray(pd.start_sols),
            hx_table=np.asarray(pd.hx_table),
            ht_table=np.asarray(pd.ht_table),
            factored=_factor_tables(pd.hx_table, pd.ht_table),
        )

    @classmethod
    def from_arrays(cls, other) -> "TrifocalProblem":
        """Rebuild from any object with the same numpy fields (e.g. the JAX
        package's TrifocalProblem); the factored tables are recompiled."""
        return cls(
            num_vars=int(other.num_vars),
            num_params=int(other.num_params),
            num_tracks=int(other.num_tracks),
            start_params=np.asarray(other.start_params, np.complex64),
            start_sols=np.asarray(other.start_sols, np.complex64),
            hx_table=np.asarray(other.hx_table),
            ht_table=np.asarray(other.ht_table),
            factored=_factor_tables(np.asarray(other.hx_table),
                                    np.asarray(other.ht_table)),
        )


def pad_params(p: torch.Tensor) -> torch.Tensor:
    """Append the constant-1 parameter slot (index num_params)."""
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def pad_vars(x: torch.Tensor) -> torch.Tensor:
    """Append the homogeneous-1 variable slot (index num_vars)."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def cayley_to_rotation(r: torch.Tensor) -> torch.Tensor:
    """Cayley parameters (..., 3) -> rotation matrix (..., 3, 3): the
    unnormalised form, then column normalisation (every column norm is
    1 + |r|^2, so this is the exact Cayley transform)."""
    r1, r2, r3 = r[..., 0], r[..., 1], r[..., 2]
    one = torch.ones_like(r1)
    m = torch.stack(
        [
            one + r1 * r1 - (r2 * r2 + r3 * r3),
            2 * (r1 * r2 - r3),
            2 * (r1 * r3 + r2),
            2 * (r1 * r2 + r3),
            one + r2 * r2 - (r1 * r1 + r3 * r3),
            2 * (r2 * r3 - r1),
            2 * (r1 * r3 - r2),
            2 * (r2 * r3 + r1),
            one + r3 * r3 - (r1 * r1 + r2 * r2),
        ],
        dim=-1,
    ).reshape(r.shape[:-1] + (3, 3))
    return m / torch.linalg.vector_norm(m, dim=-2, keepdim=True)


def solution_to_pose(
    x: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solution vectors (..., 30) -> (R21, R31, t21, t31) from the real parts.

    Translations stay unnormalised (the inlier test is invariant to their
    scale)."""
    xr = x.real if x.is_complex() else x
    return (
        cayley_to_rotation(xr[..., CAY21_SLICE]),
        cayley_to_rotation(xr[..., CAY31_SLICE]),
        xr[..., T21_SLICE],
        xr[..., T31_SLICE],
    )
