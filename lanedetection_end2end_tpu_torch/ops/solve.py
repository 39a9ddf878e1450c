"""Tiny symmetric-positive-definite solves, unrolled.

Counterpart of `lanedetection_end2end_tpu/ops/solve.py`: the WLS normal
equations are (order+1)x(order+1) SPD systems with order <= 3, solved by an
unrolled Cholesky over element-wise tensor arithmetic (batched over the
leading dims, differentiable through autograd).
"""

from __future__ import annotations

import torch


def spd_solve(Z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Solve Z b = x for SPD Z of static size n<=8, batched over leading dims.

    Args:
      Z: (..., n, n) symmetric positive definite.
      x: (..., n).
    Returns:
      b: (..., n).
    """
    n = Z.shape[-1]
    if n > 8:
        return torch.linalg.solve(Z, x.unsqueeze(-1))[..., 0]
    # Cholesky Z = L L^T, unrolled; reads only the lower triangle
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = Z[..., j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(d)
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = Z[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    # forward substitution L y = x
    y = [None] * n
    for i in range(n):
        s = x[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T b = y
    b = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * b[k]
        b[i] = s / L[i][i]
    return torch.stack(b, dim=-1)
