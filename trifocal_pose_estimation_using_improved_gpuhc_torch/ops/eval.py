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
    (float32; the card must not run them in TF32)."""
    return torch.complex(z.real @ c, z.imag @ c)


def eval_all_factored(
    problem: TrifocalProblem,
    x: torch.Tensor,
    p: torch.Tensor,
    diff_params: torch.Tensor,
    need_h: bool = True,
    need_ht: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Fused (Hx, H, -Ht) in the monomial-factored form.

    Returns Hx (B, E, V) always; H and -Ht (B, E) or None per the flags.
    """
    f = problem.factored
    n = problem.num_vars
    dev = x.device
    xp = pad_vars(x)
    pa = p[:, _idx(f.pp_a, dev)]
    pb = p[:, _idx(f.pp_b, dev)]
    P = pa * pb

    X2 = xp[:, _idx(f.qm_a, dev)] * xp[:, _idx(f.qm_b, dev)]
    PX2 = P[:, _idx(f.hx_q, dev)] * X2[:, _idx(f.hx_m, dev)]
    hx_nz = complex_matmul_real(PX2, torch.as_tensor(f.hx_C, device=dev))
    hx_padded = torch.cat([hx_nz, torch.zeros_like(hx_nz[:, :1])], dim=1)
    hx = hx_padded[:, _idx(f.hx_scatter, dev)].reshape(x.shape[0], n, n)

    h = mht = None
    if need_h or need_ht:
        X3 = (xp[:, _idx(f.cm_a, dev)] * xp[:, _idx(f.cm_b, dev)]
              * xp[:, _idx(f.cm_c, dev)])
        X3g = X3[:, _idx(f.ht_m, dev)]
        htc = torch.as_tensor(f.ht_C, device=dev)
        q = _idx(f.ht_q, dev)
        if need_h:
            h = complex_matmul_real(P[:, q] * X3g, htc)
        if need_ht:
            da = diff_params[:, _idx(f.pp_a, dev)]
            db = diff_params[:, _idx(f.pp_b, dev)]
            dP = da * pb + db * pa  # product rule on the pair
            mht = -complex_matmul_real(dP[:, q] * X3g, htc)
    return hx, h, mht
