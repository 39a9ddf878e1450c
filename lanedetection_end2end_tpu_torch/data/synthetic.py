"""Synthetic TuSimple-format dataset generation.

The port's copy of `lanedetection_end2end_tpu/data/synthetic.py`: from the
same seed it writes the same label files and the same PNG files, byte for
byte.

The reference's large label blobs (Curve_parameters.json, lanes_ordered.json,
label_data_all.json) are absent from its checkout (SURVEY.md §0), so this
module generates a geometrically CONSISTENT synthetic dataset in the exact
on-disk format the loaders expect: lane curves are sampled as 2nd-degree
polynomials in the normalized bird's-eye view, then projected into the
original 1280x720 image through the same homography the model uses — so the
BEV `poly_params`, the per-row x coordinates, the segmentation masks, and the
rendered images all agree, and a correctly implemented pipeline can fit them
to near-zero loss.

Conventions (derived from the reference's flip/reorder logic —
Backprojection_Loss/Dataloader/Load_Data_new.py:169-180 swaps lane pairs
[1,0,3,2] and gt classes 1<->2 / 3<->4, and test.py:76 reorders the line
branch [1,2,0,3]):
  lane rows / gt classes: [ego-left(1), ego-right(2), outer-left(3),
                           outer-right(4)]
  label_new 10-slot "lines": slots 3:7 = [outer-left, ego-left, ego-right,
                           outer-right] (so `mirror_list` is an involution
                           mapping each lane to its mirror).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator

import numpy as np
from PIL import Image

from lanedetection_end2end_tpu_torch.data.labels import write_json_lines
from lanedetection_end2end_tpu_torch.geometry import bev_matrices_normalized

H_SAMPLES = list(range(160, 720, 10))  # the 56 TuSimple sampling heights
_ORIG_W, _ORIG_H = 1280, 720


def _save_mask(gt: np.ndarray, path: str) -> None:
    """Save a class mask as a palette PNG with DISTINCT palette colors.

    Without an explicit palette PIL writes all-black palette entries and the
    PNG optimizer may then merge indices, collapsing the lane classes."""
    im = Image.fromarray(gt, mode="P")
    im.putpalette([v for i in range(256) for v in (i, i, i)])
    im.save(path)


def _bev_rows(heights: np.ndarray):
    """y_eval/y_prime for original-image heights, normalized parameterization.

    The math of `write_lsq_results` (Birds_Eye_View_Loss/Dataloader/
    Load_Data_new.py:352-354): y_d = (h-80)/639 (bottom-640 crop), projected
    through M, flipped to the fit's bottom-up coordinate.
    """
    M, M_inv = bev_matrices_normalized()
    y_d = (heights - 80.0) / 639.0
    y_prime = (M[1, 1] * y_d + M[1, 2]) / (M[2, 1] * y_d + M[2, 2])
    return M_inv, y_prime, 1.0 - y_prime


def _lane_x_pixels(coeff: np.ndarray, heights: np.ndarray) -> np.ndarray:
    """Original-image x (pixels) of a BEV polynomial at given heights."""
    M_inv, y_prime, y_eval = _bev_rows(heights)
    x_bev = coeff[0] * y_eval ** 2 + coeff[1] * y_eval + coeff[2]
    denom = M_inv[2, 0] * x_bev + M_inv[2, 1] * y_prime + M_inv[2, 2]
    x_im = (M_inv[0, 0] * x_bev + M_inv[0, 1] * y_prime + M_inv[0, 2]) / denom
    return x_im * (_ORIG_W - 1)


def sample_scene(rng: np.random.Generator, four_lanes_p: float = 0.85):
    """Sample per-lane BEV coefficients [a, b, c]; zeros = absent lane
    (README.md:40). Ego lanes always exist; outer lanes with probability
    `four_lanes_p` each."""
    curvature = rng.uniform(-0.08, 0.08)
    slope = rng.uniform(-0.10, 0.10)
    center = rng.uniform(0.47, 0.53)
    half_ego = rng.uniform(0.045, 0.06)
    width_out = rng.uniform(0.09, 0.12)
    cs = [center - half_ego, center + half_ego,
          center - half_ego - width_out, center + half_ego + width_out]
    coeffs = np.zeros((4, 3))
    for k, c in enumerate(cs):
        present = k < 2 or rng.uniform() < four_lanes_p
        if present:
            coeffs[k] = [curvature + rng.normal(0, 0.01),
                         slope + rng.normal(0, 0.01), c]
    return coeffs


def render_scene(coeffs: np.ndarray, rng: np.random.Generator,
                 horizon_h: int = 272):
    """Render (image uint8 HxWx3, gt uint8 HxW) at the original 1280x720.

    `horizon_h` is where the BEV trapezoid starts (y_d = 0.3 -> h ~ 272);
    lanes are only drawn below it, matching where the reference's labels have
    valid points.
    """
    img = np.full((_ORIG_H, _ORIG_W, 3), 60, dtype=np.float32)
    img += rng.normal(0, 6, size=img.shape).astype(np.float32)
    # simple sky/road shading
    img[:horizon_h] += 40
    gt = np.zeros((_ORIG_H, _ORIG_W), dtype=np.uint8)
    rows = np.arange(horizon_h, _ORIG_H, dtype=np.float64)
    for k in range(4):
        if not coeffs[k].any():
            continue
        xs = _lane_x_pixels(coeffs[k], rows)
        # width grows towards the camera like a real lane marking
        widths = 2 + 8 * (rows - horizon_h) / (_ORIG_H - horizon_h)
        for r, x, w in zip(rows.astype(int), xs, widths):
            if not np.isfinite(x):
                continue
            xi = int(round(x))
            lo, hi = max(0, xi - int(w)), min(_ORIG_W, xi + int(w) + 1)
            if lo >= hi or xi < 0 or xi >= _ORIG_W:
                continue
            gt[r, lo:hi] = k + 1
            img[r, lo:hi] = 230 + rng.normal(0, 4)
    return np.clip(img, 0, 255).astype(np.uint8), gt


def scene_labels(coeffs: np.ndarray, rng: np.random.Generator,
                 raw_file: str) -> Dict[str, dict]:
    """All label-file records for one scene."""
    heights = np.array(H_SAMPLES, dtype=np.float64)
    lanes = np.full((4, len(H_SAMPLES)), -2, dtype=np.int64)
    for k in range(4):
        if not coeffs[k].any():
            continue
        xs = _lane_x_pixels(coeffs[k], heights)
        ok = (heights >= 272) & (xs >= 0) & (xs <= _ORIG_W - 1)
        lanes[k, ok] = np.round(xs[ok]).astype(np.int64)

    lines = [-1] * 10
    # slots 3:7 = [outer-left, ego-left, ego-right, outer-right]
    for slot, lane in zip((3, 4, 5, 6), (2, 0, 1, 3)):
        if coeffs[lane].any():
            lines[slot] = int(rng.integers(0, 2))

    tusimple_lanes = [row.tolist() for row in lanes if (row != -2).any()]
    return {
        # BEV-tree Curve_parameters.json records double as the validation gt
        # (Birds_Eye_View_Loss/Load_Data_new.py:449 + write_lsq_results reads
        # lanes/h_samples from them), so they carry the full 4-row matrix.
        "curves": {"poly_params": coeffs.tolist(), "lanes": lanes.tolist(),
                   "h_samples": H_SAMPLES, "raw_file": raw_file},
        "ordered": {"lanes": lanes.tolist(), "h_samples": H_SAMPLES,
                    "raw_file": raw_file},
        "lines": {"lines": lines, "raw_file": raw_file},
        "tusimple": {"lanes": tusimple_lanes, "h_samples": H_SAMPLES,
                     "raw_file": raw_file},
    }


def make_synthetic_root(root: str, num_train: int = 16, num_test: int = 4,
                        seed: int = 0) -> Dict[str, str]:
    """Write a complete synthetic dataset tree.

    Layout (paths returned in the dict):
      root/images/NNNN.png          1280x720 RGB training images
      root/ground_truth/NNNN.png    P-mode class masks
      root/Labels/{Curve_parameters,lanes_ordered,label_new,label_data_all}.json
      root/test_set/clips/...       test images + root/test_set/test_label.json
    """
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    gt_dir = os.path.join(root, "ground_truth")
    labels_dir = os.path.join(root, "Labels")
    test_dir = os.path.join(root, "test_set")
    for d in (img_dir, gt_dir, labels_dir,
              os.path.join(test_dir, "clips")):
        os.makedirs(d, exist_ok=True)

    curves, ordered, lines, tusimple = [], [], [], []
    for i in range(num_train):
        name = f"{i + 1:04d}.png"
        coeffs = sample_scene(rng)
        image, gt = render_scene(coeffs, rng)
        Image.fromarray(image).save(os.path.join(img_dir, name))
        _save_mask(gt, os.path.join(gt_dir, name))
        rec = scene_labels(coeffs, rng, raw_file=f"images/{name}")
        curves.append(rec["curves"])
        ordered.append(rec["ordered"])
        lines.append(rec["lines"])
        tusimple.append(rec["tusimple"])

    test_labels = []
    for i in range(num_test):
        raw = f"clips/{i + 1:04d}.png"
        coeffs = sample_scene(rng)
        image, _ = render_scene(coeffs, rng)
        Image.fromarray(image).save(os.path.join(test_dir, raw))
        rec = scene_labels(coeffs, rng, raw_file=raw)
        test_labels.append(rec["tusimple"])

    paths = {
        "image_dir": img_dir,
        "gt_dir": gt_dir,
        "curves_file": os.path.join(labels_dir, "Curve_parameters.json"),
        "lanes_file": os.path.join(labels_dir, "lanes_ordered.json"),
        "line_file": os.path.join(labels_dir, "label_new.json"),
        "labels_all_file": os.path.join(labels_dir, "label_data_all.json"),
        "test_dir": test_dir,
        "test_label_file": os.path.join(test_dir, "test_label.json"),
    }
    write_json_lines(paths["curves_file"], curves)
    write_json_lines(paths["lanes_file"], ordered)
    write_json_lines(paths["line_file"], lines)
    write_json_lines(paths["labels_all_file"], tusimple)
    write_json_lines(paths["test_label_file"], test_labels)
    return paths


class SyntheticLanes:
    """In-memory random-batch source for benchmarks: device-shaped arrays
    with no disk or PIL in the loop (isolates model throughput from input IO).
    """

    def __init__(self, batch_size: int, resize: int = 256, nclasses: int = 4,
                 profile: str = "bp", seed: int = 0):
        self.batch_size = batch_size
        self.resize = resize
        self.nclasses = nclasses
        self.profile = profile
        self._rng = np.random.default_rng(seed)

    def batch(self) -> Dict[str, np.ndarray]:
        B, H, W = self.batch_size, self.resize, 2 * self.resize
        rng = self._rng
        out = {
            "image": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
            "gt": rng.integers(0, self.nclasses + 1, (B, H, W)).astype(np.int32),
            "idx": np.arange(B, dtype=np.int32),
            "is_valid": np.zeros(B, dtype=bool),
            "horizon": np.zeros((B, H), dtype=np.float32),
        }
        if self.profile == "bev":
            out["params"] = rng.normal(0.5, 0.1, (B, 4, 3)).astype(np.float32)
            out["line"] = rng.integers(0, 3, (B, 4)).astype(np.int32)
        else:
            out["lanes"] = rng.uniform(0, W - 1, (B, 4, 56)).astype(np.float32)
            out["valid_points"] = (rng.uniform(size=(B, 4, 56)) > 0.3
                                   ).astype(np.float32)
            out["line"] = (rng.uniform(size=(B, 4)) > 0.3).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch()
