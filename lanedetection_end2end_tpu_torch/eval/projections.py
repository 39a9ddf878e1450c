"""Backprojection of fitted BEV polynomials to original-image coordinates.

Counterpart of `lanedetection_end2end_tpu/eval/projections.py`
(`Projections.compute_coordinates`): the Vandermonde rows of the 56
TuSimple heights and M_inv are float32 constants on the device, and every
lane of every image backprojects in one float32 contraction, written as an
element-wise product and sum so that TF32 cannot touch it (y_eval^3 is
about 1.4e7 at resize 256). `compute_coordinates_with_M` backprojects
with each sample's own matrices, for the learned homography, in the
same element-wise float32 form (`geometry/dlt.py::backproject_with_M`).
"""

from __future__ import annotations

import numpy as np
import torch

from lanedetection_end2end_tpu_torch.geometry import bev_matrices_pixel
from lanedetection_end2end_tpu_torch.geometry.dlt import backproject_with_M


class Projections:
    """Maps (..., order+1) BEV coefficients -> (..., 56) original-image x,
    on `device` (a torch device; the CPU by default)."""

    def __init__(self, resize: int = 256, order: int = 3,
                 no_mapping: bool = False, device="cpu"):
        if order not in (0, 1, 2, 3):
            raise NotImplementedError(
                f"Requested order {order} for polynomial fit is not "
                "implemented")
        M, M_inv = bev_matrices_pixel(resize, no_mapping)
        start, delta = 160, 10
        self.factor = 640.0 / resize
        y_d = (np.arange(start, 720, delta, dtype=np.float64) - 80.0
               ) / self.factor
        y_prime = (M[1, 1] * y_d + M[1, 2]) / (M[2, 1] * y_d + M[2, 2])
        y_eval = (resize - 1.0) - y_prime
        cols = [y_eval ** p for p in range(order, 0, -1)] + [
            np.ones_like(y_eval)]
        f32 = dict(dtype=torch.float32, device=device)
        self.Y = torch.tensor(np.stack(cols, axis=1), **f32)  # (56, o+1)
        self.y_prime = torch.tensor(y_prime, **f32)             # (56,)
        # M_inv's entries as float32 values, scalars of the contraction
        self._Mi = [float(v) for v in np.float32(M_inv).ravel()]
        self.order = order

    def compute_coordinates(self, beta: torch.Tensor) -> torch.Tensor:
        """beta (..., order+1) -> x in original-image pixels (..., 56):
        x' = Y @ beta at the 56 heights, back through M_inv with the
        perspective divide, times 640 / resize."""
        x_prime = (beta.float()[..., None, :] * self.Y).sum(-1)
        Mi, yp = self._Mi, self.y_prime
        denom = Mi[6] * x_prime + Mi[7] * yp + Mi[8]
        x_cal = (Mi[0] * x_prime + Mi[1] * yp + Mi[2]) / denom
        return x_cal * self.factor

    def compute_coordinates_with_M(self, beta: torch.Tensor,
                                   M_b: torch.Tensor,
                                   M_inv_b: torch.Tensor) -> torch.Tensor:
        """Per-sample variant: beta (B, C, order+1), M_b / M_inv_b
        (B, 3, 3) -> (B, C, 56) original-image x. The heights' BEV images
        follow each sample's M (the heights themselves in float32, as the
        JAX package takes them)."""
        y_d = ((torch.arange(160.0, 720.0, 10.0, device=M_b.device) - 80.0)
               / self.factor)                                     # (56,)
        x_cal = backproject_with_M(beta, y_d, 640.0 / self.factor, M_b,
                                   M_inv_b)                       # (B, C, 56)
        return x_cal * self.factor
