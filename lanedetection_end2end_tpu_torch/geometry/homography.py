"""Host numpy projective geometry for the bird's-eye-view (BEV) transform.

Counterpart of `lanedetection_end2end_tpu/geometry/homography.py`, kept as
the port's own copy. The perspective transform is an 8x8 linear solve; the
projected grid is a host constant computed once in float64.
"""

from __future__ import annotations

import numpy as np


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3x3 homography H with dst ~ H @ src (homogeneous), from 4 point pairs
    (the 8x8 system of cv2.getPerspectiveTransform, H[2,2] = 1)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    if src.shape != (4, 2) or dst.shape != (4, 2):
        raise ValueError("src and dst must be (4, 2) arrays")
    A = np.zeros((8, 8), dtype=np.float64)
    b = np.zeros((8,), dtype=np.float64)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        A[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        A[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i] = u
        b[2 * i + 1] = v
    h = np.linalg.solve(A, b)
    return np.concatenate([h, [1.0]]).reshape(3, 3)


def bev_matrices_normalized() -> tuple[np.ndarray, np.ndarray]:
    """(M, M_inv) in normalized coordinates: y_start=0.3, src x in
    {0.45, 0.55, 0.1, 0.9}, dst x in {0.45, 0.55}."""
    y_start, y_stop = 0.3, 1.0
    src = np.float64([[0.45, y_start], [0.55, y_start], [0.1, y_stop],
                      [0.9, y_stop]])
    dst = np.float64([[0.45, y_start], [0.55, y_start], [0.45, y_stop],
                      [0.55, y_stop]])
    return (get_perspective_transform(src, dst),
            get_perspective_transform(dst, src))


def eval_matrices_normalized() -> tuple[np.ndarray, np.ndarray]:
    """(M, M_inv) of the normalized trapezoid `write_lsq_results` evaluates
    with: `bev_matrices_normalized` under the name of the evaluation
    path."""
    return bev_matrices_normalized()


def homogeneous_transform(M: np.ndarray, x, y):
    """Apply a 3x3 homography to point arrays (numpy or torch), with the
    perspective divide: -> (x', y')."""
    denom = M[2, 0] * x + M[2, 1] * y + M[2, 2]
    x_out = (M[0, 0] * x + M[0, 1] * y + M[0, 2]) / denom
    y_out = (M[1, 0] * x + M[1, 1] * y + M[1, 2]) / denom
    return x_out, y_out


def bev_matrices_pixel(resize: int = 256, no_mapping: bool = False
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(M, M_inv) in pixel coordinates of the (resize, 2*resize) image:
    y_start=0.2*resize, y_stop=resize-1, src x in {0.45, 0.55, 0.02, 0.97}
    * 2*resize, dst x in {0.45, 0.55} * 2*resize. `no_mapping` -> identity."""
    if no_mapping:
        eye = np.identity(3)
        return eye, eye.copy()
    w = 2 * resize
    y_start = 0.20 * resize
    y_stop = resize - 1
    src = np.float64([[0.45 * w, y_start], [0.55 * w, y_start],
                      [0.02 * w, y_stop], [0.97 * w, y_stop]])
    dst = np.float64([[0.45 * w, y_start], [0.55 * w, y_start],
                      [0.45 * w, y_stop], [0.55 * w, y_stop]])
    return (get_perspective_transform(src, dst),
            get_perspective_transform(dst, src))


def base_grid(height: int, width: int, normalized: bool) -> np.ndarray:
    """Homogeneous pixel-center grid, shape (H*W, 3): x in [0, 1-1/W] and
    y in [0, 1-1/H] when normalized, integer pixel coordinates otherwise."""
    if normalized:
        xs = np.linspace(0.0, 1.0 - 1.0 / width, width)
        ys = np.linspace(0.0, 1.0 - 1.0 / height, height)
    else:
        xs = np.arange(width, dtype=np.float64)
        ys = np.arange(height, dtype=np.float64)
    gx, gy = np.meshgrid(xs, ys)  # (H, W)
    ones = np.ones_like(gx)
    return np.stack([gx, gy, ones], axis=-1).reshape(height * width, 3)


def projective_grid(M: np.ndarray, height: int, width: int, normalized: bool
                    ) -> np.ndarray:
    """BEV-projected sampling grid, shape (H*W, 2) of (x', y'), float64."""
    g = base_grid(height, width, normalized) @ np.asarray(M, np.float64).T
    return g[:, :2] / g[:, 2:3]


def camera_roll(degrees: float, cx: float, cy: float) -> np.ndarray:
    """3x3 rotation of the image plane by `degrees` about (cx, cy): what a
    camera that is not mounted level adds in front of a BEV homography,
    M_rolled = M @ camera_roll(...). Such an M is no longer row-separable
    (M[1,0], M[2,0] != 0), so the fit takes the full-grid path."""
    t = np.deg2rad(degrees)
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, cx - c * cx + s * cy],
                     [s, c, cy - s * cx - c * cy],
                     [0.0, 0.0, 1.0]])
