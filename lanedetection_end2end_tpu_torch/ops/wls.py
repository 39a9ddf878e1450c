"""Weighted least-squares polynomial fit: the separable row-sum path and the
full-grid moment path.

Counterpart of `lanedetection_end2end_tpu/ops/wls.py` (`WLSFitter`). Per
lane k the fit solves Z beta = rhs with Z = Y^T diag(W_k^2) Y and
rhs = Y^T diag(W_k^2) x, over the BEV-projected pixel grid.

Separable homographies (M[1,0] = M[2,0] = 0, both of the reference's) map
image rows to rows, so every moment factorizes over rows:

    Z[i,j] = sum_r Y_i(r) Y_j(r) S0[r]
    rhs[i] = sum_r Y_i(r) (alpha[r] S1[r] + gamma[r] S0[r])

with S0[r] = sum_c w^2[r,c] and S1[r] = sum_c w^2[r,c] xs[c]. The
contraction of (S0 | S1) with the constant (2H, K) coefficient rows runs in
float32 as an element-wise product and sum, so no TF32 setting can lower its
precision (JAX's `Precision.HIGHEST`).

The learned homography (`geometry/dlt.py`) gives each sample its own
row-separable matrix: `sep_coeff_from_M` builds the (B, 2H, K)
coefficient rows from them, differentiably, and `fit_with_M` contracts
them with the same row sums, element-wise in float32 too; gradients reach
both the weight maps and the matrices.

A general homography (a camera roll, say) takes the full grid: a constant
(H*W, K) basis of all products Y_i*Y_j (row-major) then Y_i*x, built once
on the host, and the moments sum_n w^2[n] basis[n] from K12
(`ops/wls_moments.py`: its kernel on a CUDA tensor, its plain version on a
CPU tensor). As in JAX, x there is the raw projected x, not centred.

The Vandermonde basis is built on y/scale and beta rescaled exactly;
Tikhonov `reg_ls` plus a trace-relative floor make the solve total
(all-zero weight maps stay finite).
"""

from __future__ import annotations

import numpy as np
import torch

from lanedetection_end2end_tpu_torch.device import resolve_device
from lanedetection_end2end_tpu_torch.geometry import projective_grid
from lanedetection_end2end_tpu_torch.ops.solve import spd_solve
from lanedetection_end2end_tpu_torch.ops.wls_moments import wls_moments

REG_FLOOR = 1e-8  # relative diagonal floor making the solve total


def _vandermonde(y: np.ndarray, order: int) -> np.ndarray:
    """Columns [y^order, ..., y, 1]."""
    return np.stack([y ** p for p in range(order, -1, -1)], axis=-1)


class WLSFitter:
    """Holds the fit's constants on `device` and fits beta.

    Args:
      M: 3x3 homography (image -> BEV), host array.
      height/width: weight-map spatial shape.
      order: polynomial order (0..3).
      normalized: True for the BEV profile, False for the BP profile.
      reg_ls: Tikhonov strength in unscaled coordinates.
      device: where the constants live; None (the default) is the card,
        and raises without one. Pass "cpu" for the CPU.

    The solve is always `spd_solve` (the config's `use_cholesky` is inert).
    """

    def __init__(self, M: np.ndarray, height: int, width: int, order: int,
                 normalized: bool, reg_ls: float = 0.0, device=None):
        device = resolve_device(device)
        if order not in (0, 1, 2, 3):
            raise NotImplementedError(
                f"Requested order {order} for polynomial fit is not implemented")
        M = np.asarray(M, dtype=np.float64)
        self.separable = abs(M[1, 0]) < 1e-12 and abs(M[2, 0]) < 1e-12
        self.order = order
        self.height, self.width = height, width
        self.reg_ls = float(reg_ls)
        self.n_coeff = o1 = order + 1
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                        device=device)

        # y flipped so the fit runs bottom-up; scale from the whole grid
        grid = projective_grid(M, height, width, normalized)
        y_map = (1.0 - grid[:, 1]) if normalized else (
            float(height - 1) - grid[:, 1])
        scale = 1.0 if normalized else max(float(np.max(np.abs(y_map))),
                                           1e-12)
        self.y_scale = scale
        powers = np.arange(order, -1, -1, dtype=np.float64)
        self._unscale = f32(scale ** -powers)
        # reg_ls acts on the unscaled Z: reg_ls * scale^(-2p) in scaled coords
        self._reg_diag = f32(self.reg_ls * scale ** (-2.0 * powers))
        self.normalized = normalized
        self.sep_coeff = self.sep_xs = self.basis = None

        if not self.separable:
            Y = _vandermonde(y_map / scale, order)             # (N, o1)
            prods = (Y[:, :, None] * Y[:, None, :]).reshape(-1, o1 * o1)
            self.basis = f32(np.concatenate(
                [prods, Y * grid[:, 0:1]], axis=1))            # (N, K)
            return

        if normalized:
            xs = np.linspace(0.0, 1.0 - 1.0 / width, width)
            ys = np.linspace(0.0, 1.0 - 1.0 / height, height)
        else:
            xs = np.arange(width, dtype=np.float64)
            ys = np.arange(height, dtype=np.float64)
        D = M[2, 1] * ys + M[2, 2]
        alpha = M[0, 0] / D                            # x' = alpha*xs+gamma
        gamma = (M[0, 1] * ys + M[0, 2]) / D
        # centered, normalized column coordinate keeps S1 balanced in f32
        x0 = float(xs.mean())
        sx = max(float(np.abs(xs - x0).max()), 1e-12)
        y_rows = (M[1, 1] * ys + M[1, 2]) / D
        y_rows = (1.0 - y_rows) if normalized else (float(height - 1) - y_rows)
        Yr = _vandermonde(y_rows / scale, order)       # (H, o1)
        c0 = np.concatenate(
            [(Yr[:, :, None] * Yr[:, None, :]).reshape(height, o1 * o1),
             Yr * (gamma + alpha * x0)[:, None]], axis=1)
        c1 = np.concatenate(
            [np.zeros((height, o1 * o1)), Yr * (alpha * sx)[:, None]], axis=1)
        self.sep_coeff = f32(np.concatenate([c0, c1], axis=0))  # (2H, K)
        self.sep_xs = f32((xs - x0) / sx)                         # (W,)
        # constants of the per-sample-homography path (fit_with_M)
        self.sep_ys = f32(ys)                                     # (H,)
        self.sep_x0, self.sep_sx = x0, sx

    def __call__(self, wmaps: torch.Tensor) -> torch.Tensor:
        """Fit from activated, masked weight maps (B, H, W, C) -> beta
        (B, C, order+1), highest power first."""
        B, H, W, C = wmaps.shape
        if not self.separable:
            w = wmaps.float().reshape(B, H * W, C)      # a view, lanes inner
            return self._finish(wls_moments(w, self.basis), B, C)
        w2 = (wmaps * wmaps).float()
        S0 = w2.sum(dim=2).transpose(1, 2)                          # (B,C,H)
        S1 = (w2 * self.sep_xs[None, None, :, None]).sum(dim=2).transpose(1, 2)
        return self.beta_from_rowsums(S0, S1)

    def beta_from_rowsums(self, S0: torch.Tensor, S1: torch.Tensor
                          ) -> torch.Tensor:
        """Fit from (already masked) W-axis row sums S0, S1 (B, C, H)."""
        assert self.separable, \
            "row-sum fitting needs a row-aligned homography"
        B, C = S0.shape[0], S0.shape[1]
        S = torch.cat([S0.reshape(B * C, -1), S1.reshape(B * C, -1)],
                      dim=-1).float()
        moments = (S.unsqueeze(-1) * self.sep_coeff).sum(dim=1)  # (BC, K)
        return self._finish(moments, B, C)

    def sep_coeff_from_M(self, M_b: torch.Tensor) -> torch.Tensor:
        """Per-sample coefficient rows (B, 2H, K) from (B, 3, 3)
        row-separable homographies (M[1,0] = M[2,0] = 0): the
        differentiable twin of the host constants of `__init__`, in
        float32."""
        assert self.separable, "per-sample fitting needs separable form"
        M_b = M_b.float()
        ys = self.sep_ys[None, :]                            # (1, H)
        D = M_b[:, 2, 1:2] * ys + M_b[:, 2, 2:3]             # (B, H)
        alpha = M_b[:, 0, 0:1] / D
        gamma = (M_b[:, 0, 1:2] * ys + M_b[:, 0, 2:3]) / D
        y_rows = (M_b[:, 1, 1:2] * ys + M_b[:, 1, 2:3]) / D
        y_rows = (1.0 - y_rows) if self.normalized else (
            float(self.height - 1) - y_rows)
        t = y_rows / self.y_scale
        o1 = self.n_coeff
        Yr = torch.stack([t ** p for p in range(self.order, -1, -1)],
                         dim=-1)                             # (B, H, o1)
        prods = (Yr[..., :, None] * Yr[..., None, :]).reshape(
            *Yr.shape[:2], o1 * o1)
        c0 = torch.cat(
            [prods, Yr * (gamma + alpha * self.sep_x0)[..., None]], dim=-1)
        c1 = torch.cat(
            [torch.zeros_like(prods), Yr * (alpha * self.sep_sx)[..., None]],
            dim=-1)
        return torch.cat([c0, c1], dim=1)                    # (B, 2H, K)

    def fit_with_M(self, wmaps: torch.Tensor, M_b: torch.Tensor
                   ) -> torch.Tensor:
        """Fit with per-sample homographies: wmaps (B, H, W, C), M_b
        (B, 3, 3) row-separable -> beta (B, C, order+1); gradients reach
        both arguments. float32, contracted element-wise."""
        assert self.separable, "per-sample fitting needs separable form"
        B, C = wmaps.shape[0], wmaps.shape[-1]
        w2 = (wmaps * wmaps).float()
        S0 = w2.sum(dim=2).transpose(1, 2)                          # (B,C,H)
        S1 = (w2 * self.sep_xs[None, None, :, None]).sum(dim=2).transpose(1, 2)
        S = torch.cat([S0, S1], dim=-1)                     # (B, C, 2H)
        coeff = self.sep_coeff_from_M(M_b)                  # (B, 2H, K)
        moments = (S.unsqueeze(-1) * coeff.unsqueeze(1)).sum(dim=2)
        return self._finish(moments.reshape(B * C, -1), B, C)

    def _finish(self, moments: torch.Tensor, B: int, C: int) -> torch.Tensor:
        """Regularize + solve + unscale the fitted coefficients."""
        o1 = self.n_coeff
        Z = moments[:, :o1 * o1].reshape(B * C, o1, o1)
        X = moments[:, o1 * o1:]
        trace = torch.diagonal(Z, dim1=-2, dim2=-1).sum(-1, keepdim=True)
        floor = REG_FLOOR * (trace / o1) + torch.finfo(torch.float32).tiny
        diag = self._reg_diag[None, :] + floor                     # (BC, o1)
        Z = Z + torch.diag_embed(diag)
        beta_s = spd_solve(Z, X)
        return (beta_s * self._unscale[None, :]).reshape(B, C, o1)
