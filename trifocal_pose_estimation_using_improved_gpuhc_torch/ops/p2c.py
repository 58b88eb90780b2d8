"""The P2C strategy: parameters -> coefficients -> coefficient-indexed
evaluation, tracked by the same kernel as PH.

Counterpart of the JAX package's ``ops/p2c.py``.  The ablation ladder's
first rung is the original GPU-HC evaluation, "P2C": the target and start
parameters become coefficient polynomials in t, and H / Hx / -Ht are
evaluated against coefficient-indexed tables (``dHdx_indx_P2C.txt``,
``dHdt_indx_P2C.txt``).  The conversion from parameters to coefficients is
derived numerically: every coefficient is a linear combination of the
parameter-pair products P_q, fitted once by least squares against the PH
evaluation (``derive_coeff_map``).

``make_p2c_problem`` recasts the tables as a problem in coefficient space
(each term's coefficient paired with a constant-1 slot), so that the
tracker's constants, its solve program and the CUDA kernel apply
unchanged: ``make_fused_p2c_track_fn`` is K1 on that problem's plan, with
per-path pair coefficients mapped from the original problem's
(``fused.make_track_fn(..., coef_builder=...)``).  ``make_p2c_evaluator``
is the plain table-driven evaluator, a test oracle.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch.models.trifocal import (
    TrifocalProblem,
    _factor_tables,
    pad_vars,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import eval as ev
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
    HCConfig,
)

_X_SAMPLES = 6   # fixed generic x's of the coefficient fit
_FIT_TOL = 1e-3  # relative residual of a sample's coefficient fit


@dataclasses.dataclass(frozen=True)
class P2CTables:
    hx: np.ndarray      # (E, V, terms, 4) int: [coeff, c_idx, v1, v2]
    ht: np.ndarray      # (E, terms, 5) int: [coeff, c_idx, v1, v2, v3]
    n_coeffs: int       # coefficient slots (incl. the zero-pad slot)
    coeff_map: np.ndarray  # (n_coeffs, Q) complex64: c = coeff_map @ P


def load_p2c_tables(problem_dir: str, num_vars: int = 30
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The two P2C tables as (E, V, hx_terms, 4) and (E, ht_terms, 5),
    parts innermost; the term counts come from the files' sizes."""
    hx = np.loadtxt(os.path.join(problem_dir, "dHdx_indx_P2C.txt"),
                    dtype=np.int64)
    ht = np.loadtxt(os.path.join(problem_dir, "dHdt_indx_P2C.txt"),
                    dtype=np.int64)
    n = num_vars
    if hx.size % (n * n * 4) or ht.size % (n * 5):
        raise ValueError(f"P2C tables of {hx.size} and {ht.size} integers "
                         f"are not (V, V, terms, 4) and (V, terms, 5) with "
                         f"V={n}")
    return (hx.reshape(n, n, hx.size // (n * n * 4), 4),
            ht.reshape(n, ht.size // (n * 5), 5))


def _pair_products(problem: TrifocalProblem, p: np.ndarray) -> np.ndarray:
    """P_q = p[a]*p[b] for the factored pair list; p (..., P+1)."""
    f = problem.factored
    return p[..., np.asarray(f.pp_a)] * p[..., np.asarray(f.pp_b)]


def _coeff_design(tables_hx: np.ndarray, tables_ht: np.ndarray,
                  n_coeffs: int, x: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Linear maps from coefficient values to Hx entries (E*V rows) and H
    values (E rows) at x (V,)."""
    V = tables_hx.shape[0]
    xp = np.concatenate([x, np.ones(1, x.dtype)]).astype(np.complex128)
    e, v, _ = np.indices(tables_hx.shape[:3])
    ci, k, v1, v2 = np.moveaxis(tables_hx, -1, 0)
    design_hx = np.zeros((V * V, n_coeffs), np.complex128)
    np.add.at(design_hx, ((e * V + v).ravel(), k.ravel()),
              (ci * xp[v1] * xp[v2]).ravel())
    e, _ = np.indices(tables_ht.shape[:2])
    ci, k, v1, v2, v3 = np.moveaxis(tables_ht, -1, 0)
    design_h = np.zeros((V, n_coeffs), np.complex128)
    np.add.at(design_h, (e.ravel(), k.ravel()),
              (ci * xp[v1] * xp[v2] * xp[v3]).ravel())
    return design_hx, design_h


def derive_coeff_map(problem: TrifocalProblem, problem_dir: str,
                     samples: int = 120, rng_seed: int = 0) -> P2CTables:
    """Fit the coefficients as combinations of the pair products.

    For random (x, p) the PH evaluation (``ops/eval``'s direct evaluators,
    complex64 on the CPU) gives Hx and H; the P2C tables give them as
    linear functions of the unknown coefficient values, so each sample's
    coefficients come by least squares over several fixed x's, and
    stacking samples gives the linear map from the pair products P(p) to
    the coefficients (both fits in complex128).  The zero-pad slot's design
    column is zero, so the minimum-norm fit gives it 0.  Raises ValueError
    ("table interpretation mismatch") when a sample's fit leaves a
    relative residual above 1e-3."""
    hx_t, ht_t = load_p2c_tables(problem_dir, problem.num_vars)
    n_coeffs = int(max(hx_t[..., 1].max(), ht_t[..., 1].max())) + 1
    rng = np.random.default_rng(rng_seed)
    V, P1 = problem.num_vars, problem.num_params + 1

    # Several fixed generic x's make the coefficient system uniquely
    # determined (one x leaves a null space).
    xs = [rng.standard_normal(V) + 1j * rng.standard_normal(V)
          for _ in range(_X_SAMPLES)]
    design = np.concatenate([np.concatenate(_coeff_design(hx_t, ht_t,
                                                          n_coeffs, x))
                             for x in xs])
    ps = []
    for _ in range(samples):
        p = rng.standard_normal(P1) + 1j * rng.standard_normal(P1)
        p[P1 - 1] = 1.0
        ps.append(p)
    ps = np.stack(ps)

    # Every (sample, x) probe in one batch, sample-major.
    xb = torch.as_tensor(np.tile(np.stack(xs), (samples, 1))
                         .astype(np.complex64))
    pb = torch.as_tensor(np.repeat(ps, len(xs), axis=0).astype(np.complex64))
    hx_ref = ev.eval_Hx_direct(problem, xb, pb).numpy().astype(np.complex128)
    h_ref = ev.eval_H_direct(problem, xb, pb).numpy().astype(np.complex128)
    rhs = np.concatenate([hx_ref.reshape(samples, len(xs), V * V),
                          h_ref.reshape(samples, len(xs), V)], axis=2)
    rhs = rhs.reshape(samples, -1).T                    # (rows, S)
    C, *_ = np.linalg.lstsq(design, rhs, rcond=None)    # (n_coeffs, S)
    fit = (np.abs(design @ C - rhs).max(axis=0)
           / np.maximum(np.abs(rhs).max(axis=0), 1.0))
    if fit.max() > _FIT_TOL:
        raise ValueError(
            f"P2C tables do not reproduce the PH evaluation (residual "
            f"{fit.max():.2e}): table interpretation mismatch")
    M, *_ = np.linalg.lstsq(_pair_products(problem, ps), C.T, rcond=None)
    return P2CTables(hx=hx_t.astype(np.int32), ht=ht_t.astype(np.int32),
                     n_coeffs=n_coeffs, coeff_map=M.T.astype(np.complex64))


def make_p2c_problem(problem: TrifocalProblem,
                     tables: P2CTables) -> TrifocalProblem:
    """The P2C tables as a problem in coefficient space: its parameters are
    the n_coeffs coefficients with the constant 1 at index n_coeffs, and
    each term [c_int, c_idx, v...] becomes the PH term [c_int, c_idx,
    n_coeffs, v...].  Padding terms (c_int 0) leave the factored tables, as
    every zero-weight term does."""
    V, C = problem.num_vars, tables.n_coeffs
    hx_t, ht_t = tables.hx, tables.ht
    hx5 = np.zeros(hx_t.shape[:3] + (5,), np.int64)
    hx5[..., :2] = hx_t[..., :2]
    hx5[..., 2] = C                     # constant-1 parameter slot
    hx5[..., 3:] = hx_t[..., 2:]
    ht6 = np.zeros(ht_t.shape[:2] + (6,), np.int64)
    ht6[..., :2] = ht_t[..., :2]
    ht6[..., 2] = C
    ht6[..., 3:] = ht_t[..., 2:]
    # The reference layouts: (var, term, part, eq) and (term, part, eq).
    hx5 = hx5.transpose(1, 2, 3, 0)
    ht6 = ht6.transpose(1, 2, 0)
    c_start = tables.coeff_map @ _pair_products(
        problem, np.asarray(problem.start_params))
    return TrifocalProblem(
        num_vars=V, num_params=C, num_tracks=problem.num_tracks,
        start_params=np.concatenate([c_start, np.ones(1, np.complex64)])
        .astype(np.complex64),
        start_sols=problem.start_sols, hx_table=hx5, ht_table=ht6,
        factored=_factor_tables(hx5, ht6))


def make_fused_p2c_track_fn(problem: TrifocalProblem, tables: P2CTables,
                            cfg: HCConfig, plain: bool = False):
    """P2C on the tracker: ``fused.make_track_fn`` (``make_plain_track_fn``
    with ``plain``) on ``make_p2c_problem``'s plan, with the same
    ``track(x0, target_params)`` contract as on the original problem.

    Each path's pseudo-pair coefficients are its original pair coefficients
    (``fused.build_pair_coefs`` in ``cfg.pair_coef_basis``) mapped through
    the coefficient map, row by row in float32 real planes (the map is
    linear, so it maps either basis's quadratics exactly): the same
    parameter homotopy, evaluated through the coefficient tables."""
    pproblem = make_p2c_problem(problem, tables)
    pf = pproblem.factored
    # Every pseudo pair is (coefficient, constant): P'_q(t) = c_{pp_a[q]}(t).
    if not (pf.pp_b == tables.n_coeffs).all():
        raise ValueError("a P2C term pairs two coefficients")
    M = tables.coeff_map[pf.pp_a]
    mats = {}

    def coef_builder(target_params: torch.Tensor) -> torch.Tensor:
        dev = target_params.device
        if str(dev) not in mats:
            mats[str(dev)] = tuple(
                torch.as_tensor(a.T.astype(np.float32), device=dev)
                for a in (M.real, M.imag))              # (Q, Q') each
        mr, mi = mats[str(dev)]
        base = fused.build_pair_coefs(problem, target_params,
                                      cfg.pair_coef_basis)
        re, im = base.real, base.imag                   # (B, 3, Q)
        return torch.complex(re @ mr - im @ mi, im @ mr + re @ mi)

    maker = fused.make_plain_track_fn if plain else fused.make_track_fn
    return maker(pproblem, cfg, coef_builder=coef_builder)


def make_p2c_evaluator(problem: TrifocalProblem, tables: P2CTables):
    """The plain table-driven P2C evaluator (a test oracle, like the direct
    evaluators of ``ops/eval``).

    Returns eval_p2c(x (B, V), start (P+1,), target (B, P+1), t (B,)) ->
    (Hx (B, E, V), H (B, E), -Ht (B, E)), complex: the coefficients are the
    pair products of p(t) = (1 - t) start + t target (and their product
    rule for -Ht) through the coefficient map."""
    M = torch.as_tensor(tables.coeff_map)              # (C, Q)
    hx_t = torch.as_tensor(tables.hx, dtype=torch.long)
    ht_t = torch.as_tensor(tables.ht, dtype=torch.long)
    f = problem.factored
    pp_a = torch.as_tensor(f.pp_a, dtype=torch.long)
    pp_b = torch.as_tensor(f.pp_b, dtype=torch.long)

    def eval_p2c(x, start, target, t):
        dev = x.device
        m, a, b = M.to(dev), pp_a.to(dev), pp_b.to(dev)
        hx_i, ht_i = hx_t.to(dev), ht_t.to(dev)
        p_t = ev.param_homotopy(t, start, target)
        d = target - start
        c = (p_t[:, a] * p_t[:, b]) @ m.T                       # (B, C)
        dc = (d[:, a] * p_t[:, b] + d[:, b] * p_t[:, a]) @ m.T
        xp = pad_vars(x)
        xx = xp[:, hx_i[..., 2]] * xp[:, hx_i[..., 3]]        # (B, E, V, T)
        hx = (hx_i[..., 0].to(x.dtype) * c[:, hx_i[..., 1]] * xx).sum(-1)
        xxx = (xp[:, ht_i[..., 2]] * xp[:, ht_i[..., 3]]
               * xp[:, ht_i[..., 4]])                          # (B, E, T)
        w = ht_i[..., 0].to(x.dtype)
        h = (w * c[:, ht_i[..., 1]] * xxx).sum(-1)
        mht = -(w * dc[:, ht_i[..., 1]] * xxx).sum(-1)
        return hx, h, mht

    return eval_p2c
