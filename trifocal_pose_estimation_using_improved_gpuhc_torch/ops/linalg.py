"""Batched small complex linear solves: the oracle tracker's full-pivot
Gaussian elimination.

Counterpart of the JAX package's ``ops/linalg.py`` (``solve_batched``):
partial pivoting on |Re| + |Im| (the reference's MAGMA metric), the first
row winning a tie as ``jnp.argmax`` picks it, a zero pivot replaced by 1 so
that dead paths give finite garbage, each step's update over the whole
augmented matrix, then back-substitution from the last row up.  It is
plain torch on any device: the JAX package computes it outside its Pallas
kernel, so no kernel of its own is due.

``torch.linalg.solve`` is another function: LAPACK and cuBLAS pivot on |z|
and treat a singular pivot otherwise.
"""

from __future__ import annotations

import torch


def solve_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a[i] @ x[i] = b[i] for each batch element.

    a: (B, N, N) complex64 or complex128, b: (B, N) of the same dtype ->
    (B, N).  Partial-pivoted Gaussian elimination over the batch."""
    B, N, _ = a.shape
    m = torch.cat([a, b[..., None]], dim=-1)  # (B, N, N+1) augmented
    rows = torch.arange(N, device=a.device)
    ar = torch.arange(B, device=a.device)
    one = torch.ones((), dtype=a.dtype, device=a.device)

    for k in range(N):
        # The first row of the largest |Re| + |Im| at or below k.
        piv = torch.view_as_real(m[:, k:, k]).abs().sum(dim=-1).argmax(
            dim=1) + k
        # Swap rows k and piv; where piv == k both writes store one row.
        row_p = m[ar, piv]
        m[ar, piv] = m[:, k]
        m[:, k] = row_p

        # Eliminate below the pivot.
        pivot = m[:, k, k]
        safe = torch.where(pivot == 0, one, pivot)
        factor = torch.where(rows[None, :, None] > k,
                             m[:, :, k:k + 1] / safe[:, None, None], 0.0)
        m = m - factor * m[:, k:k + 1]

    # Back-substitution.  x starts at zero, so the sum over the whole row
    # adds exactly the solved entries.
    x = torch.zeros((B, N), dtype=a.dtype, device=a.device)
    for k in range(N - 1, -1, -1):
        row = m[:, k]
        diag = row[:, k]
        safe = torch.where(diag == 0, one, diag)
        x[:, k] = (row[:, N] - torch.sum(row[:, :N] * x, dim=-1)) / safe
    return x
