"""Validation predictions in the TuSimple format, from fitted BEV curves.

Counterpart of `lanedetection_end2end_tpu/eval/results.py`
(`write_lsq_results`): it reads the per-image records the BEV validation
writes ({params, line_id, horizon_est, lanes, h_samples, raw_file}),
evaluates each lane's polynomial at the TuSimple sampling heights in the
normalized bird's-eye view, backprojects through the inverse of the
normalized homography, and writes one TuSimple prediction line per
record, the same lines byte for byte as the JAX package's. Host numpy:
a few hundred records once per validation epoch.
"""

from __future__ import annotations

import json

import numpy as np

from lanedetection_end2end_tpu_torch.data.labels import read_json_lines
from lanedetection_end2end_tpu_torch.geometry import (
    eval_matrices_normalized, homogeneous_transform)


def write_lsq_results(src_file: str, dst_file: str, nclasses: int,
                      all_branches_ready: bool, horizon_on: bool,
                      resize: int, no_ortho: bool,
                      test_phase: bool = False) -> None:
    """Fitted-curve records of `src_file` -> TuSimple prediction lines in
    `dst_file`.

    A lane is skipped (left at -2) when its gt row has no point, or, with
    `all_branches_ready`, when the line branch says the outer lane is
    absent; with `horizon_on` too, the estimated horizon sets the top row.
    Without `no_ortho` the curve is evaluated in the bird's-eye view and
    backprojected; with it, directly in the image's normalized rows. Points
    outside [max(210, top), bottom] of the lane's gt rows are -2. The
    reference's drawing and intersection options are not carried (the
    JAX package omits them too).
    """
    factor = 640 / resize
    M, M_inv = eval_matrices_normalized()
    lines = read_json_lines(src_file)
    with open(dst_file, "w") as f:
        for line in lines:
            h_samples = line["h_samples"]
            y_orig = np.array(h_samples)
            # the sampling heights in the normalized bottom-640 crop
            y_d = (np.array(h_samples) - 80) / 639
            y_prime = (M[1][1] * y_d + M[1][2]) / (M[2][1] * y_d + M[2][2])
            y_eval = 1 - y_prime
            lanes_json = np.full((nclasses, len(h_samples)), -2,
                                 dtype=np.int64)
            lanes = line["lanes"]
            params = line["params"]
            line_id = line["line_id"]
            horizon = line["horizon_est"]

            no_left_line = line_id[0] == 0
            no_right_line = line_id[3] == 0
            for j in range(len(params)):
                lane = lanes if test_phase else lanes[j]
                if all_branches_ready:
                    # lanes [l, r, ll, rr]; line slots [ll, l, r, rr]
                    if (j == 2 and no_left_line) or (j == 3 and no_right_line):
                        continue
                elif not [x for x in lane if x != -2]:
                    continue

                h = [y for x, y in zip(lane, h_samples) if x != -2]
                if len(h) == 0:
                    minimum, maximum = 250, 710
                else:
                    minimum, maximum = np.min(h), np.max(h)
                if all_branches_ready and horizon_on:
                    minimum = sum(horizon) * factor + 80
                params_j = [0] * (3 - len(params[j])) + list(params[j])
                a, b, c = params_j

                if not no_ortho:
                    x_new = a * y_eval ** 2 + b * y_eval + c
                    x_new, y_new = homogeneous_transform(M_inv, x_new,
                                                         y_prime)
                else:
                    y_new = 1 - y_d
                    x_new = a * y_new ** 2 + b * y_new + c
                x_new, y_new = x_new * 1279, y_new * 639 + 80
                x_new = np.int_(np.round(x_new))
                x_new = [x if max(210, minimum) <= y <= maximum else -2
                         for x, y in zip(x_new, y_orig)]
                lanes_json[j] = x_new

            out = dict(line)
            out["run_time"] = 20
            out["lanes"] = lanes_json.tolist()
            json.dump(out, f)
            f.write("\n")
