"""Loss functions: area / MSE / backprojection curve losses, weighted CE,
BCE-with-logits.

Counterpart of `lanedetection_end2end_tpu/ops/losses.py`. Absent-lane
masking is `where`-based (total functions), as there.
`BackprojectionLoss.with_M` is the per-sample-homography variant of the
learned homography (`geometry/dlt.py`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lanedetection_end2end_tpu_torch.device import resolve_device
from lanedetection_end2end_tpu_torch.geometry import bev_matrices_pixel
from lanedetection_end2end_tpu_torch.geometry.dlt import backproject_with_M


# ----------------------------------------------------------------------
# Curve-parameter losses (BEV space)
# ----------------------------------------------------------------------

def area_loss(params: torch.Tensor, gt_params: torch.Tensor, order: int = 2,
              weight_funct: str = "none", t: float = 0.7) -> torch.Tensor:
    """Squared area between curves, closed form:
    int_0^t W(y) (x_pred(y) - x_gt(y))^2 dy with W in {1, 1-y, 1-sqrt(y)},
    averaged over present lanes (no gt coefficient exactly 0), 0 when no
    lane is present.

    Args:
      params: (B, order+1) predicted coefficients, highest power first.
      gt_params: (B, order+1) ground-truth coefficients.
    """
    diff = params.reshape(gt_params.shape) - gt_params
    a = diff[:, 0]
    b = diff[:, 1]
    if order == 2:
        c = diff[:, 2]
        if weight_funct == "none":
            loss_fit = (a**2)*(t**5)/5 + 2*a*b*(t**4)/4 + \
                       (b**2 + c*2*a)*(t**3)/3 + 2*b*c*(t**2)/2 + (c**2)*t
        elif weight_funct == "linear":
            loss_fit = c**2*t - t**5*((2*a*b)/5 - a**2/5) + \
                       t**2*(b*c - c**2/2) - (a**2*t**6)/6 - \
                       t**4*(b**2/4 - (a*b)/2 + (a*c)/2) + \
                       t**3*(b**2/3 - (2*c*b)/3 + (2*a*c)/3)
        elif weight_funct == "quadratic":
            loss_fit = t**3*(1/3*b**2 + 2/3*a*c) - \
                       t**(7/2)*(2/7*b**2 + 4/7*a*c) + \
                       c**2*t + 0.2*a**2*t**5 - 2/11*a**2*t**(11/2) - \
                       2/3*c**2*t**(3/2) + 0.5*a*b*t**4 - \
                       4/9*a*b*t**(9/2) + b*c*t**2 - 0.8*b*c*t**(5/2)
        else:
            raise NotImplementedError(
                "The requested weight function is not implemented")
    elif order == 1:
        loss_fit = (b**2)*t + a*b*(t**2) + ((a**2)*(t**3))/3
    else:
        raise NotImplementedError("The requested order is not implemented")

    mask = (gt_params != 0).all(dim=1)
    n = mask.sum()
    total = torch.where(mask, loss_fit, torch.zeros_like(loss_fit)).sum()
    return torch.where(n > 0, total / n.clamp(min=1), torch.zeros_like(total))


def mse_params_loss(params: torch.Tensor,
                    gt_params: torch.Tensor) -> torch.Tensor:
    """Plain MSE on curve parameters."""
    diff = params.reshape(gt_params.shape) - gt_params
    return (diff * diff).mean()


# ----------------------------------------------------------------------
# Backprojection loss (BP profile)
# ----------------------------------------------------------------------

class BackprojectionLoss:
    """MSE on x-coordinates backprojected to the original image perspective.

    Precomputes on the host, in float64, the 56 TuSimple sampling heights,
    their BEV images under the pixel homography and the Vandermonde rows,
    and holds them in float32 on `device`. y_eval^3 reaches ~1.4e9, so the
    contraction with the coefficients runs in float32 as an element-wise
    product and sum, which no TF32 setting can lower; never feed it bf16.
    `device=None` (the default) is the card, and raises without one; pass
    "cpu" for the CPU.
    """

    def __init__(self, resize: int = 256, order: int = 3,
                 no_mapping: bool = False, device=None):
        device = resolve_device(device)
        if order not in (0, 1, 2, 3):
            raise NotImplementedError(
                f"Requested order {order} for polynomial fit is not implemented")
        M, M_inv = bev_matrices_pixel(resize, no_mapping)
        start, delta = 160, 10
        # original-image heights 160, 170, ..., 710 in the resized crop
        y_d = (np.arange(start, 720, delta, dtype=np.float64) - 80.0) / 2.5
        n_h = y_d.shape[0]  # 56
        y_prime = (M[1, 1] * y_d + M[1, 2]) / (M[2, 1] * y_d + M[2, 2])
        y_eval = (resize - 1.0) - y_prime
        cols = [y_eval ** p for p in range(order, 0, -1)] + [np.ones(n_h)]
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                        device=device)
        self.num_heights = n_h
        self.Y = f32(np.stack(cols, axis=1))       # (56, order+1)
        self.y_prime = f32(y_prime)                # (56,)
        self.M_inv = [[float(np.float32(v)) for v in row] for row in M_inv]
        self.y_d = f32(y_d)                        # (56,) resized heights
        self.order = order
        self.resize = resize

    def __call__(self, params: torch.Tensor, x_gt: torch.Tensor,
                 valid_samples: torch.Tensor):
        """Args:
          params: (B, order+1) BEV polynomial coefficients.
          x_gt: (B, 56) ground-truth x at the sampling heights (resized
            coordinates).
          valid_samples: (B, 56) 0/1 validity mask.
        Returns (loss scalar, x_cal * valid of shape (B, 56)).
        """
        params = params.float()
        x_prime = (params.unsqueeze(1) * self.Y.unsqueeze(0)).sum(-1)
        Mi = self.M_inv
        yp = self.y_prime[None, :]
        denom = Mi[2][0] * x_prime + Mi[2][1] * yp + Mi[2][2]
        x_cal = (Mi[0][0] * x_prime + Mi[0][1] * yp + Mi[0][2]) / denom
        valid = valid_samples.to(x_cal.dtype)
        x_err = (x_gt.to(x_cal.dtype) - x_cal) * valid
        count = valid.sum()
        loss = torch.where(count > 0,
                           (x_err * x_err).sum() / count.clamp(min=1.0),
                           torch.zeros_like(count))
        return loss, x_cal * valid

    def with_M(self, params: torch.Tensor, x_gt: torch.Tensor,
               valid_samples: torch.Tensor, M_b: torch.Tensor,
               M_inv_b: torch.Tensor):
        """`__call__` with each sample's own matrices M_b, M_inv_b
        (B, 3, 3): the heights' BEV images, their Vandermonde rows and the
        backprojection follow the learned homography, so gradients reach
        it through the loss geometry as well as through the fit
        (`geometry/dlt.py::backproject_with_M`, element-wise float32 as
        `__call__`)."""
        x_cal = backproject_with_M(params, self.y_d, self.resize, M_b,
                                   M_inv_b)                       # (B, 56)
        valid = valid_samples.to(x_cal.dtype)
        x_err = (x_gt.to(x_cal.dtype) - x_cal) * valid
        count = valid.sum()
        loss = torch.where(count > 0,
                           (x_err * x_err).sum() / count.clamp(min=1.0),
                           torch.zeros_like(count))
        return loss, x_cal * valid


# ----------------------------------------------------------------------
# Classification losses
# ----------------------------------------------------------------------

def weighted_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           class_weights: torch.Tensor) -> torch.Tensor:
    """Per-pixel weighted cross entropy over NHWC logits, the weighted
    NLLLoss mean sum(w[t] * nll) / sum(w[t]).

    Args:
      logits: (B, H, W, n_cls).
      targets: (B, H, W) int class indices.
      class_weights: (n_cls,).
    """
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long().unsqueeze(-1))[..., 0]
    w = class_weights.to(logits.dtype)[targets.long()]
    return (w * nll).sum() / w.sum()


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """nn.BCEWithLogitsLoss (mean): the horizon and line-presence heads."""
    targets = targets.to(logits.dtype)
    loss = (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return loss.mean()


def cross_entropy_logits(logits: torch.Tensor,
                         targets: torch.Tensor) -> torch.Tensor:
    """nn.CrossEntropyLoss over class axis 1 with trailing dims: logits
    (B, 3, 4) against targets (B, 4)."""
    logp = F.log_softmax(logits, dim=1)
    nll = -logp.gather(1, targets.long().unsqueeze(1))[:, 0, :]
    return nll.mean()
