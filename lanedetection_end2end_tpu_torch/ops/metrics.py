"""Evaluation metrics.

Counterpart of `lanedetection_end2end_tpu/ops/metrics.py`: the vectorized
trapezoidal exact-area metric between two order-2 polynomials.
"""

from __future__ import annotations

import torch


def trapezoidal_area(pred: torch.Tensor, gt: torch.Tensor, a: float = 0.0,
                     b: float = 0.7, n: int = 100) -> torch.Tensor:
    """Area of |x_pred(y) - x_gt(y)| over [a, b] by the trapezium rule.

    pred/gt: (..., 3) coefficients [a1, b1, c1] of x = a1*y^2 + b1*y + c1
    (callers zero-pad lower orders on the left). Returns one area per row,
    with the endpoints halved.
    """
    h = (b - a) / n
    ys = torch.linspace(a, b, n + 1, dtype=torch.float64,
                        device=pred.device).to(pred.dtype)
    d = pred - gt
    vals = torch.abs(d[..., 0:1] * ys ** 2 + d[..., 1:2] * ys + d[..., 2:3])
    s = vals[..., 0] / 2.0 + vals[..., 1:-1].sum(-1) + vals[..., -1] / 2.0
    return s * h
