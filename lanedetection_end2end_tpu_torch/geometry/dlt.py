"""Differentiable DLT: per-sample homographies for the learned-homography
option (the reference README's "finetuned homography" configuration).

Counterpart of `lanedetection_end2end_tpu/geometry/dlt.py`. A small head
(`models/dlt.py::HomographyHead`) predicts three offsets of the target
trapezoid of the BP pixel homography; a 6-equation system re-solves the
homography per sample, differentiably, so the backprojection loss reaches
the head through the fit and through the loss geometry.

The homography is held to the row-separable form

    H = [[h0, h1, h2],
         [ 0, h3, h4],
         [ 0, h5,  1]]

so y' depends on y alone and the WLS fitter's separable row-sum path
applies with per-sample coefficient rows (`ops/wls.py::fit_with_M`). The
(B, 6, 6) system is built in float32 and solved with `torch.linalg.solve`
(LU with partial pivoting, differentiable), as the JAX package solves it
with `jnp.linalg.solve` in float32. The system is badly conditioned at
pixel scale (cond(A) about 2.8e4 at resize 32 and 1.9e6 at resize 256),
so two LU implementations agree only to within that conditioning; the
tests hold both packages against a float64 solve of the same system.
"""

from __future__ import annotations

import numpy as np
import torch


def dlt_anchor_points(resize: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) 4-point trapezoids of the BP pixel homography, float64,
    ordered [top-left, top-right, bottom-left, bottom-right]."""
    w = 2 * resize
    y_top = 0.20 * resize
    y_bot = resize - 1.0
    src = np.float64([[0.45 * w, y_top], [0.55 * w, y_top],
                      [0.02 * w, y_bot], [0.97 * w, y_bot]])
    dst = np.float64([[0.45 * w, y_top], [0.55 * w, y_top],
                      [0.45 * w, y_bot], [0.55 * w, y_bot]])
    return src, dst


def dlt_system(offsets: torch.Tensor, resize: int = 256
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The DLT system A h = b of `dlt_homography`: (A (B, 6, 6), b (B, 6))
    in the dtype of `offsets` (float32 from the head; a float64 witness
    passes float64 offsets).

    Unknowns h = (h0, h1, h2, h3, h4, h5); with the denominator
    D(y) = h5 y + 1:
      x-equation at (x, y) -> u:  h0 x + h1 y + h2 - u y h5 = u
      y-equation at y -> v:       h3 y + h4 - v y h5 = v
    Six equations: the y-map at both rows, the x-map at all four anchors.
    Columns of `offsets` (normalized units): dx_left moves both left
    anchors, dx_right both right ones (times the width), dy_top the top
    edge (times the height)."""
    src, dst = dlt_anchor_points(resize)
    (xs_tl, y_top), (xs_tr, _), (xs_bl, y_bot), (xs_br, _) = src
    (xd_l, _), (xd_r, _), _, _ = dst
    B = offsets.shape[0]
    w = 2.0 * resize
    u_l = xd_l + offsets[:, 0] * w        # left-lane target x (both rows)
    u_r = xd_r + offsets[:, 1] * w        # right-lane target x
    v_top = y_top + offsets[:, 2] * resize  # the bottom edge stays fixed
    zeros = offsets.new_zeros(B)
    ones = offsets.new_ones(B)
    c = lambda v: offsets.new_full((B,), float(v))

    def x_eq(x, y, u):
        return torch.stack([c(x), c(y), ones, zeros, zeros, -u * y], -1), u

    def y_eq(y, v):
        return torch.stack([zeros, zeros, zeros, c(y), ones, -v * y], -1), v

    rows, rhs = zip(y_eq(y_bot, c(y_bot)),
                    x_eq(xs_bl, y_bot, u_l),
                    x_eq(xs_br, y_bot, u_r),
                    y_eq(y_top, v_top),
                    x_eq(xs_tl, y_top, u_l),
                    x_eq(xs_tr, y_top, u_r))
    return torch.stack(rows, dim=1), torch.stack(rhs, dim=1)


def dlt_homography(offsets: torch.Tensor, resize: int = 256
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample constrained homographies from learned trapezoid offsets.

    Args:
      offsets: (B, 3) in normalized units (the head emits tanh / 16):
        (dx_left, dx_right, dy_top).
      resize: image height; the width is 2 * resize.
    Returns:
      (M, M_inv): (B, 3, 3) float32. At zero offsets M is the fixed
      `bev_matrices_pixel` matrix (the fixed 8-DOF solution already has
      the separable structure). M_inv is normalized to M_inv[2, 2] = 1.
    A float64 witness solves `dlt_system` of float64 offsets and takes
    `dlt_matrices` of that.
    """
    A, b = dlt_system(offsets.float(), resize)
    return dlt_matrices(torch.linalg.solve(A, b))


def dlt_matrices(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The unknowns h (B, 6) of the DLT system -> (M, M_inv) (B, 3, 3) in
    h's dtype, M_inv normalized to M_inv[2, 2] = 1."""
    B = h.shape[0]
    z1 = h.new_zeros(B, 1)
    o1 = h.new_ones(B, 1)
    M = torch.cat([h[:, 0:3], z1, h[:, 3:5], z1, h[:, 5:6], o1],
                  dim=1).reshape(B, 3, 3)
    M_inv = torch.linalg.inv(M)
    return M, M_inv / M_inv[:, 2:3, 2:3]


def backproject_with_M(coeffs: torch.Tensor, y_d: torch.Tensor,
                       resize: float, M_b: torch.Tensor,
                       M_inv_b: torch.Tensor) -> torch.Tensor:
    """Per-sample backprojection of BEV polynomials: coeffs (B, ...,
    order+1), the heights y_d (N,) of the resized crop, M_b / M_inv_b
    (B, 3, 3) -> x (B, ..., N) in the resized crop. The heights' BEV
    images y' follow each sample's M, the polynomial is evaluated at
    y_eval = (resize - 1) - y', and (x', y') goes back through M_inv with
    the perspective divide. float32, contracted element-wise (y_eval^3
    reaches about 1.4e9 at resize 256), so no TF32 setting can lower it:
    the one body of `BackprojectionLoss.with_M` and
    `Projections.compute_coordinates_with_M`."""
    M_b, Mi = M_b.float(), M_inv_b.float()
    B, o1, n = coeffs.shape[0], coeffs.shape[-1], y_d.shape[-1]
    lead = (1,) * (coeffs.dim() - 2)           # the axes between B and o1
    y_d = y_d[None, :]                                        # (1, N)
    y_prime = ((M_b[:, 1, 1:2] * y_d + M_b[:, 1, 2:3])
               / (M_b[:, 2, 1:2] * y_d + M_b[:, 2, 2:3]))     # (B, N)
    y_eval = (resize - 1.0) - y_prime
    Yb = torch.stack([y_eval ** p for p in range(o1 - 1, 0, -1)]
                     + [torch.ones_like(y_eval)], dim=-1)     # (B, N, o1)
    x_prime = (coeffs.float()[..., None, :]
               * Yb.reshape(B, *lead, n, o1)).sum(-1)         # (B, ..., N)
    yp = y_prime.reshape(B, *lead, n)
    m = lambda i, j: Mi[:, i, j].reshape(B, *lead, 1)
    denom = m(2, 0) * x_prime + m(2, 1) * yp + m(2, 2)
    return (m(0, 0) * x_prime + m(0, 1) * yp + m(0, 2)) / denom
