"""The fit's and the projection's constants, in float64 on the host.

A frozen copy of the lane-detection geometry (the reference repository's
bird's-eye-view homographies, the separable weighted-least-squares fit
and the TuSimple backprojection), written from the published math. It
imports nothing of the program: the benchmark holds the program to it.
"""

from __future__ import annotations

import math

import numpy as np

H_SAMPLES = np.arange(160, 720, 10, dtype=np.float64)  # TuSimple heights
REG_FLOOR = 1e-8  # relative diagonal floor that makes every solve total


def perspective_transform(src, dst) -> np.ndarray:
    """3x3 H with dst ~ H @ src from four point pairs, H[2, 2] = 1."""
    A, b = np.zeros((8, 8)), np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(src, dst)):
        A[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        A[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i], b[2 * i + 1] = u, v
    return np.append(np.linalg.solve(A, b), 1.0).reshape(3, 3)


def matrices(profile: str, resize: int, no_mapping: bool = False):
    """(M, M_inv): 'bp' in pixels of the (resize, 2 resize) image, 'bev' in
    normalized coordinates."""
    if profile == "bev":
        y0, y1 = 0.3, 1.0
        src = [[0.45, y0], [0.55, y0], [0.1, y1], [0.9, y1]]
        dst = [[0.45, y0], [0.55, y0], [0.45, y1], [0.55, y1]]
    elif no_mapping:
        return np.eye(3), np.eye(3)
    else:
        w, y0, y1 = 2 * resize, 0.2 * resize, resize - 1.0
        src = [[0.45 * w, y0], [0.55 * w, y0], [0.02 * w, y1], [0.97 * w, y1]]
        dst = [[0.45 * w, y0], [0.55 * w, y0], [0.45 * w, y1], [0.55 * w, y1]]
    return perspective_transform(src, dst), perspective_transform(dst, src)


def zero_rows(resize: int, mask_percentage: float) -> int:
    """The top rows that carry no fit weight."""
    return math.ceil(resize * mask_percentage)


def fit_constants(profile: str, resize: int, order: int, reg_ls: float,
                  no_mapping: bool = False) -> dict:
    """The separable fit: with S0[r] = sum_c w^2 and S1[r] = sum_c w^2 xs[c]
    per image row r, the moments are [S0 | S1] @ coeff (2H, K), K = o1^2 +
    o1; Z = moments[:o1^2] + diag(reg + floor), rhs = moments[o1^2:], and
    beta = solve(Z, rhs) * unscale, highest power first."""
    M, _ = matrices(profile, resize, no_mapping)
    if abs(M[1, 0]) > 1e-12 or abs(M[2, 0]) > 1e-12:
        raise ValueError("the reference fits row-separable homographies")
    H, W, o1 = resize, 2 * resize, order + 1
    bev = profile == "bev"
    if bev:
        xs = np.linspace(0.0, 1.0 - 1.0 / W, W)
        ys = np.linspace(0.0, 1.0 - 1.0 / H, H)
    else:
        xs, ys = np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64)
    D = M[2, 1] * ys + M[2, 2]
    alpha = M[0, 0] / D
    gamma = (M[0, 1] * ys + M[0, 2]) / D
    y_rows = (M[1, 1] * ys + M[1, 2]) / D
    y_rows = (1.0 - y_rows) if bev else (H - 1.0 - y_rows)
    # the y scale of the whole projected grid (rows map to rows)
    scale = 1.0 if bev else max(float(np.abs(y_rows).max()), 1e-12)
    x0 = float(xs.mean())
    sx = max(float(np.abs(xs - x0).max()), 1e-12)
    powers = np.arange(order, -1, -1, dtype=np.float64)
    Yr = (y_rows / scale)[:, None] ** powers[None, :]           # (H, o1)
    c0 = np.concatenate([(Yr[:, :, None] * Yr[:, None, :]).reshape(H, -1),
                         Yr * (gamma + alpha * x0)[:, None]], axis=1)
    c1 = np.concatenate([np.zeros((H, o1 * o1)),
                         Yr * (alpha * sx)[:, None]], axis=1)
    return {"coeff": np.concatenate([c0, c1], axis=0),           # (2H, K)
            "xs": (xs - x0) / sx,                                # (W,)
            "reg_diag": reg_ls * scale ** (-2.0 * powers),
            "unscale": scale ** -powers, "order": order}


def projection_constants(resize: int, order: int, no_mapping: bool = False,
                         factor: float = None) -> dict:
    """The TuSimple heights in the resized crop, their bird's-eye images
    and Vandermonde rows: x' = Y @ beta, then x = (Mi0 . [x', y', 1]) /
    (Mi2 . [x', y', 1]) in resized pixels. `factor` maps original to
    resized heights: 640 / resize for the served lanes; the training loss
    divides by 2.5 at every resize, as the reference repository's does."""
    M, M_inv = matrices("bp", resize, no_mapping)
    factor = 640.0 / resize if factor is None else factor
    y_d = (H_SAMPLES - 80.0) / factor
    y_prime = (M[1, 1] * y_d + M[1, 2]) / (M[2, 1] * y_d + M[2, 2])
    y_eval = (resize - 1.0) - y_prime
    Y = np.stack([y_eval ** p for p in range(order, 0, -1)]
                 + [np.ones_like(y_eval)], axis=1)
    return {"Y": Y, "y_prime": y_prime, "M_inv": M_inv, "factor": factor}
