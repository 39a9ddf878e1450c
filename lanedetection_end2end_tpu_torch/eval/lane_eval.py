"""TuSimple LaneEval benchmark — pure numpy, no sklearn.

The port's copy of `lanedetection_end2end_tpu/eval/lane_eval.py`.

Scoring parity with `eval_lane.py` (Birds_Eye_View_Loss/eval_lane.py:10-95,
identical copy in Backprojection_Loss): per-gt-lane accuracy is the fraction
of sampled points within 20/cos(angle) pixels, a lane matches when that
fraction reaches 0.85, FP/FN accounting with the >4-lane forgiveness rules.

The reference fits `sklearn.LinearRegression` just to get the lane's slope
(eval_lane.py:16-24); the closed-form 1-D least-squares slope is the same
number, so sklearn is dropped.
"""

from __future__ import annotations

import json
from typing import List, Sequence

import numpy as np


class LaneEval:
    pixel_thresh = 20
    pt_thresh = 0.85

    @staticmethod
    def get_angle(xs: np.ndarray, y_samples: np.ndarray) -> float:
        """arctan of the least-squares slope dx/dy over valid (x>=0) points."""
        xs, ys = xs[xs >= 0], y_samples[xs >= 0]
        if len(xs) > 1:
            ym = ys.mean()
            denom = float(((ys - ym) ** 2).sum())
            if denom == 0.0:
                return 0.0
            k = float(((ys - ym) * (xs - xs.mean())).sum()) / denom
            return float(np.arctan(k))
        return 0.0

    @staticmethod
    def line_accuracy(pred: np.ndarray, gt: np.ndarray, thresh: float) -> float:
        pred = np.where(pred >= 0, pred, -100.0)
        gt = np.where(gt >= 0, gt, -100.0)
        return float(np.sum(np.abs(pred - gt) < thresh) / len(gt))

    @staticmethod
    def bench(pred: Sequence[Sequence[float]], gt: Sequence[Sequence[float]],
              y_samples: Sequence[float], running_time: float):
        """(accuracy, fp_rate, fn_rate) for one image (eval_lane.py:32-57)."""
        if any(len(p) != len(y_samples) for p in pred):
            raise Exception("Format of lanes error.")
        if running_time > 200 or len(gt) + 2 < len(pred):
            return 0.0, 0.0, 1.0
        y = np.array(y_samples, dtype=np.float64)
        angles = [LaneEval.get_angle(np.array(x, dtype=np.float64), y)
                  for x in gt]
        threshs = [LaneEval.pixel_thresh / np.cos(a) for a in angles]
        line_accs: List[float] = []
        fn, matched = 0.0, 0.0
        pred_arrs = [np.array(p, dtype=np.float64) for p in pred]
        for x_gts, thresh in zip(gt, threshs):
            g = np.array(x_gts, dtype=np.float64)
            accs = [LaneEval.line_accuracy(p, g, thresh) for p in pred_arrs]
            max_acc = max(accs) if accs else 0.0
            if max_acc < LaneEval.pt_thresh:
                fn += 1
            else:
                matched += 1
            line_accs.append(max_acc)
        fp = len(pred) - matched
        if len(gt) > 4 and fn > 0:
            fn -= 1  # forgive one miss when >4 gt lanes (eval_lane.py:52-53)
        s = sum(line_accs)
        if len(gt) > 4:
            s -= min(line_accs)
        return (s / max(min(4.0, len(gt)), 1.0),
                fp / len(pred) if len(pred) > 0 else 0.0,
                fn / max(min(len(gt), 4.0), 1.0))

    @staticmethod
    def bench_one_submit(pred_file: str, gt_file: str) -> List[float]:
        """[accuracy, fp, fn] averaged over the submission (eval_lane.py:60-95)."""
        try:
            with open(pred_file) as f:
                json_pred = [json.loads(line) for line in f if line.strip()]
        except BaseException:
            raise Exception("Fail to load json file of the prediction.")
        with open(gt_file) as f:
            json_gt = [json.loads(line) for line in f if line.strip()]
        if len(json_gt) != len(json_pred):
            raise Exception("We do not get the predictions of all the test tasks")
        gts = {g["raw_file"]: g for g in json_gt}
        accuracy = fp = fn = 0.0
        for pred in json_pred:
            if ("raw_file" not in pred or "lanes" not in pred
                    or "run_time" not in pred):
                raise Exception(
                    "raw_file or lanes or run_time not in some predictions.")
            if pred["raw_file"] not in gts:
                raise Exception("Some raw_file from your predictions do not "
                                "exist in the test tasks.")
            gt = gts[pred["raw_file"]]
            try:
                a, p, n = LaneEval.bench(pred["lanes"], gt["lanes"],
                                         gt["h_samples"], pred["run_time"])
            except BaseException:
                raise Exception("Format of lanes error.")
            accuracy += a
            fp += p
            fn += n
        num = len(gts)
        return [accuracy / num, fp / num, fn / num]
