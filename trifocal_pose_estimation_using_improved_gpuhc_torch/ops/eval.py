"""Batched evaluators for H, Hx and -Ht in plain torch complex64.

Counterpart of the JAX package's ``ops/eval.py``, same conventions:

  x:   (B, num_vars) complex solutions (homogeneous slot appended inside).
  p:   (B, num_params + 1) parameter values p(t), constant-1 slot last.
  Hx[b, e, v] = dH_e/dx_v;  minus_ht = -dH/dt.

``eval_all_factored`` is the monomial-factored form the tracker uses;
the ``*_direct`` evaluators re-express the raw index tables term by term
and serve only as test oracles.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch.models.trifocal import (
    TrifocalProblem,
    pad_vars,
)


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.long, device=device)


def factored_tables(problem: TrifocalProblem, device) -> dict:
    """The problem's factored tables as tensors on ``device`` (index
    arrays as int64), for callers that evaluate many times on one device:
    pass them to ``eval_all_factored`` as ``tables``."""
    return {k: (_idx(v, device) if v.dtype.kind in "iu"
                else torch.as_tensor(v, device=device))
            for k, v in vars(problem.factored).items()}


def param_homotopy(
    t: torch.Tensor, start_params: torch.Tensor, target_params: torch.Tensor
) -> torch.Tensor:
    """p(t) = t * target + (1 - t) * start, per path: t (B,) real,
    start (P+1,), target (B, P+1) -> (B, P+1) complex."""
    tc = t.to(target_params.dtype)[..., None]
    return target_params * tc + start_params * (1.0 - tc)


def eval_H_direct(problem: TrifocalProblem, x: torch.Tensor,
                  p: torch.Tensor) -> torch.Tensor:
    """H(x, t): (B, num_eqs), straight from the dHdt index table."""
    tbl = _idx(problem.ht_table, x.device)
    xp = pad_vars(x)
    c = tbl[:, 0, :].to(x.dtype)
    pp = p[:, tbl[:, 1, :]] * p[:, tbl[:, 2, :]]
    xx = xp[:, tbl[:, 3, :]] * xp[:, tbl[:, 4, :]] * xp[:, tbl[:, 5, :]]
    return torch.sum(c * pp * xx, dim=1)


def eval_minus_Ht_direct(problem: TrifocalProblem, x: torch.Tensor,
                         p: torch.Tensor,
                         diff_params: torch.Tensor) -> torch.Tensor:
    """-dH/dt: (B, num_eqs); diff_params = target - start per path."""
    tbl = _idx(problem.ht_table, x.device)
    xp = pad_vars(x)
    c = tbl[:, 0, :].to(x.dtype)
    i1, i2 = tbl[:, 1, :], tbl[:, 2, :]
    dpp = diff_params[:, i1] * p[:, i2] + diff_params[:, i2] * p[:, i1]
    xx = xp[:, tbl[:, 3, :]] * xp[:, tbl[:, 4, :]] * xp[:, tbl[:, 5, :]]
    return -torch.sum(c * dpp * xx, dim=1)


def eval_Hx_direct(problem: TrifocalProblem, x: torch.Tensor,
                   p: torch.Tensor) -> torch.Tensor:
    """Hx(x, t): (B, num_eqs, num_vars), straight from the dHdx table."""
    tbl = _idx(problem.hx_table, x.device)
    xp = pad_vars(x)
    c = tbl[:, :, 0, :].to(x.dtype)
    pp = p[:, tbl[:, :, 1, :]] * p[:, tbl[:, :, 2, :]]
    xx = xp[:, tbl[:, :, 3, :]] * xp[:, tbl[:, :, 4, :]]
    return torch.sum(c * pp * xx, dim=2).transpose(1, 2)


def complex_matmul_real(z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, K) complex @ (K, N) real -> (B, N) complex, as two real matmuls
    (in z's real dtype; the card must not run them in TF32)."""
    c = c.to(z.real.dtype)
    return torch.complex(z.real @ c, z.imag @ c)


def eval_all_factored(
    problem: TrifocalProblem,
    x: torch.Tensor,
    p: torch.Tensor,
    diff_params: torch.Tensor,
    need_h: bool = True,
    need_ht: bool = True,
    tables: Optional[dict] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Fused (Hx, H, -Ht) in the monomial-factored form.

    Returns Hx (B, E, V) always; H and -Ht (B, E) or None per the flags.
    ``tables``: ``factored_tables(problem, x.device)``, made here if not
    given.
    """
    f = factored_tables(problem, x.device) if tables is None else tables
    n = problem.num_vars
    xp = pad_vars(x)
    pa = p[:, f["pp_a"]]
    pb = p[:, f["pp_b"]]
    P = pa * pb

    X2 = xp[:, f["qm_a"]] * xp[:, f["qm_b"]]
    PX2 = P[:, f["hx_q"]] * X2[:, f["hx_m"]]
    hx_nz = complex_matmul_real(PX2, f["hx_C"])
    hx_padded = torch.cat([hx_nz, torch.zeros_like(hx_nz[:, :1])], dim=1)
    hx = hx_padded[:, f["hx_scatter"]].reshape(x.shape[0], n, n)

    h = mht = None
    if need_h or need_ht:
        X3 = xp[:, f["cm_a"]] * xp[:, f["cm_b"]] * xp[:, f["cm_c"]]
        X3g = X3[:, f["ht_m"]]
        q = f["ht_q"]
        if need_h:
            h = complex_matmul_real(P[:, q] * X3g, f["ht_C"])
        if need_ht:
            da = diff_params[:, f["pp_a"]]
            db = diff_params[:, f["pp_b"]]
            dP = da * pb + db * pa  # product rule on the pair
            mht = -complex_matmul_real(dP[:, q] * X3g, f["ht_C"])
    return hx, h, mht
