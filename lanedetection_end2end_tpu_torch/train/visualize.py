"""Weight-map and fitted-curve panels of a training or validation batch.

Counterpart of `lanedetection_end2end_tpu/train/visualize.py`, drawn with
PIL on every host (the JAX package draws a matplotlib figure; the port
does not use matplotlib). For sample 0 of a batch, three panels of the
image's size stacked top to bottom and saved as a PNG under
save_path/example/{train,valid,pretrain,testset}: the input image, the
normalized sum of its lanes' weight maps on a viridis-like ramp, and a
white panel with each lane's fitted curve drawn over the image rows in
the lane's colour (BP: x = poly(H-1 - row) in pixels; BEV, normalized
coordinates: x = W poly(1 - row / (H-1))), plus, as points in the same colour,
the backprojected x coordinates when given (BP profile, at evenly spaced
rows as the JAX figure places them) or else the ground-truth curves of
BEV parameters. A panel is never skipped.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from lanedetection_end2end_tpu_torch.utils.observability import (
    mkdir_if_missing)

_COLOURS = [(230, 25, 75), (60, 180, 75), (0, 130, 200), (245, 130, 48),
            (145, 30, 180)]
# anchors of a viridis-like ramp, 0 -> 1
_RAMP = np.array([(68, 1, 84), (59, 82, 139), (33, 145, 140),
                  (94, 201, 98), (253, 231, 37)], dtype=np.float64)


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a)


def _poly(coeff, ys):
    return sum(c * ys ** p for c, p in zip(coeff, range(len(coeff) - 1, -1,
                                                        -1)))


def _combined(w: np.ndarray) -> np.ndarray:
    combined = np.zeros_like(w[0])
    for k in range(w.shape[0]):
        mx = w[k].max()
        combined = combined + (w[k] / mx if mx > 0 else w[k])
    return combined


def _ramp(v: np.ndarray) -> np.ndarray:
    """(H, W) values -> (H, W, 3) uint8 on the ramp, min to max."""
    lo, hi = float(v.min()), float(v.max())
    t = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    x = t * (len(_RAMP) - 1)
    i = np.clip(np.floor(x).astype(int), 0, len(_RAMP) - 2)
    f = (x - i)[..., None]
    return np.round(_RAMP[i] * (1 - f) + _RAMP[i + 1] * f).astype(np.uint8)


def _points(draw, xs, rows, colour):
    for x, r in zip(xs, rows):
        if np.isfinite(x):
            draw.point((float(x), float(r)), fill=colour)


def save_weightmap(mode: str, weightmaps, beta, gt_params_or_lanes, image,
                   save_path: str, batch_idx: int = 0,
                   x_cal: Optional[np.ndarray] = None,
                   resize: int = 256, normalized: bool = False) -> str:
    """Save the panels of sample 0 of a batch; returns the file's path.

    Args:
      mode: 'train' | 'valid' | 'pretrain' | 'testset' (subdirectory).
      weightmaps: (B, C, H, W) activated weight maps.
      beta: (B, C, order+1) fitted coefficients.
      gt_params_or_lanes: gt curve params (B, C, 3) or gt lane x (B, C, 56).
      image: (B, H, W, 3) input batch in [0, 1].
      x_cal: optional backprojected x coordinates (B, C, 56), BP profile,
        in pixels of the (H, 2 resize) image.
      normalized: beta in the BEV profile's normalized coordinates.
    """
    from PIL import Image, ImageDraw
    out_dir = os.path.join(save_path, "example", mode)
    mkdir_if_missing(out_dir)
    path = os.path.join(out_dir, f"idx-0_batch-{batch_idx}.png")
    w = _np(weightmaps)[0]
    img = np.clip(_np(image)[0], 0, 1)
    b, g = _np(beta)[0], _np(gt_params_or_lanes)[0]
    H, W = img.shape[:2]
    top = np.round(img * 255.0).astype(np.uint8)
    mid = _ramp(_combined(w))
    if mid.shape[:2] != (H, W):
        mid = np.asarray(Image.fromarray(mid).resize((W, H), Image.NEAREST))
    curves = Image.new("RGB", (W, H), (255, 255, 255))
    draw = ImageDraw.Draw(curves)
    rows = np.arange(H, dtype=np.float64)
    for k in range(w.shape[0]):
        colour = _COLOURS[k % len(_COLOURS)]
        xs = (_poly(b[k], 1.0 - rows / (H - 1.0)) * W if normalized
              else _poly(b[k], (H - 1.0) - rows))
        pts = [(float(x), float(r)) for x, r in zip(xs, rows)
               if np.isfinite(x) and -W < x < 2 * W]
        if len(pts) > 1:
            draw.line(pts, fill=colour, width=1)
    if x_cal is not None:
        xc = _np(x_cal)[0] * (W / (2.0 * resize))
        hs = np.arange(xc.shape[-1]) * (H - 1.0) / max(xc.shape[-1] - 1, 1)
        for k in range(xc.shape[0]):
            _points(draw, xc[k], hs, _COLOURS[k % len(_COLOURS)])
    elif g.ndim == 2 and g.shape[-1] <= 4:  # BEV parameters, normalized
        ys = np.linspace(0, 1, H)
        for k in range(min(w.shape[0], g.shape[0])):
            _points(draw, (_poly(g[k], ys) * W)[::4],
                    ((1 - ys) * (H - 1))[::4], _COLOURS[k % len(_COLOURS)])
    panel = np.concatenate([top, mid, np.asarray(curves)], axis=0)
    Image.fromarray(panel).save(path)
    return path


def save_pretrain_panel(image, gt, seg_logits, save_path: str,
                        batch_idx: int) -> str:
    """The skip phase's panels of sample 0, stacked: the input, the gt
    classes and the argmax of the segmentation logits, the classes on the
    ramp."""
    from PIL import Image
    out_dir = os.path.join(save_path, "example", "pretrain")
    mkdir_if_missing(out_dir)
    path = os.path.join(out_dir, f"idx-0_batch-{batch_idx}.png")
    img = np.clip(_np(image)[0], 0, 1)
    seg = np.argmax(_np(seg_logits)[0], axis=-1)
    panels = [np.round(img * 255.0).astype(np.uint8),
              _ramp(_np(gt)[0] * 1.0), _ramp(seg * 1.0)]
    Image.fromarray(np.concatenate(panels, axis=0)).save(path)
    return path
