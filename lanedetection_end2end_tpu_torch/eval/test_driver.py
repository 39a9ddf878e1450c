"""Test-set inference driver.

Counterpart of `lanedetection_end2end_tpu/eval/test_driver.py`: the
per-batch pipeline (the e2e forward, the sigmoid gating of the line and
horizon branches, the polynomial backprojection, the bounds clipping) runs
on the device in one function, `make_infer_fn`; the host only rounds to
ints, streams the JSON lines and scores them with LaneEval. Without the
engine the forward is `LaneNet.forward(train=False)`, the plain module
graph in `cfg.compute_dtype`, as the JAX package runs its flax graph in
its LaneNet's dtype there; with
`use_engine` it is `FusedLaneNetEngine` (the serving kernels K5 on a
card). With the learned homography, `LaneNet.forward` gives each image its
own matrices and the backprojection takes them
(`Projections.compute_coordinates_with_M`); the engine has no homography
head, so `test_model` refuses `use_engine` there rather than score a
model other than the one trained. Timing synchronizes the card around
each batch.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from lanedetection_end2end_tpu_torch.config import LaneConfig
from lanedetection_end2end_tpu_torch.data.labels import read_json_lines
from lanedetection_end2end_tpu_torch.eval.lane_eval import LaneEval
from lanedetection_end2end_tpu_torch.eval.projections import Projections
from lanedetection_end2end_tpu_torch.utils import (
    AverageMeter, mkdir_if_missing)
from lanedetection_end2end_tpu_torch.utils.profiling import span

# line-branch slots [ll, l, r, rr] -> lane order [l, r, ll, rr]
_LINE_ORDER = [1, 2, 0, 3]


def make_infer_fn(lanenet, cfg: LaneConfig, projections: Projections,
                  engine=None, packed=None):
    """-> infer(images) -> (B, 4, 56) gated lane x coordinates, float32,
    on the device of `lanenet` (or of `engine`). `images` (B, H, W, 3) are
    uint8 or float in [0, 1], on any device."""
    device = engine.device if engine is not None else (
        lanenet.fitter.sep_coeff.device)
    calls = itertools.count()

    def gated_lanes(beta, line_logits, horizon_logits, M_b, M_inv_b):
        """The lanes of `beta` (B, C, 56), -2.0 where gated: with
        `cfg.clas` an absent line and the rows above the estimated
        horizon, and any x outside the image."""
        if M_b is not None:  # the learned homography
            lanes_pred = projections.compute_coordinates_with_M(
                beta, M_b, M_inv_b)
        else:
            lanes_pred = projections.compute_coordinates(beta)  # (B, C, 56)
        if cfg.clas:
            # the horizon row: round((factor * sum(sigmoid) + 80) / 10) * 10
            horizon_pred = torch.sigmoid(horizon_logits).sum(1)
            horizon_pred = torch.round(
                (projections.factor * horizon_pred + 80.0) / 10.0) * 10.0
            line_pred = torch.round(torch.sigmoid(line_logits))
            line_pred = line_pred[:, _LINE_ORDER]
            lanes_pred = torch.where(line_pred[:, :, None] > 0, lanes_pred,
                                     -2.0)
            # rows above the estimated horizon
            bound = (horizon_pred - 160.0) / 10.0                # (B,)
            cols = torch.arange(lanes_pred.shape[-1], dtype=torch.float32,
                                device=lanes_pred.device)
            lanes_pred = torch.where(
                cols[None, None, :] < bound[:, None, None], -2.0, lanes_pred)
        # out-of-image x
        return torch.where((lanes_pred > 1279.0) | (lanes_pred < 0.0), -2.0,
                           lanes_pred)

    @torch.no_grad()
    def infer(images: torch.Tensor) -> torch.Tensor:
        with span("serve.call", device, root=next(calls)):
            with span("serve.h2d", device):
                images = images.to(device, non_blocking=True)
                if images.dtype == torch.uint8:
                    images = images.float() * (1.0 / 255.0)
            M_b = M_inv_b = None
            if engine is not None:
                beta, line_logits, horizon_logits = engine(packed, images)
            else:
                out = lanenet.forward(images, train=False,
                                      dtype=cfg.torch_dtype())
                beta, M_b, M_inv_b = out.beta, out.M, out.M_inv
                line_logits = out.line_logits
                horizon_logits = out.horizon_logits
            with span("serve.lanes", device):
                return gated_lanes(beta, line_logits, horizon_logits, M_b,
                                   M_inv_b)

    return infer


_COLORMAP = [(255, 0, 0), (0, 255, 0), (255, 255, 0), (0, 0, 255),
             (0, 128, 128)]


def _draw_test_image(json_line: dict, test_dir: str, save_path: str,
                     im_id: int) -> None:
    """--draw_testset: the predicted points drawn on the original test
    image, saved under save_path/example/testset."""
    from PIL import Image, ImageDraw
    out_dir = os.path.join(save_path, "example", "testset")
    mkdir_if_missing(out_dir)
    img_path = os.path.join(test_dir, json_line["raw_file"])
    if not os.path.exists(img_path):
        return
    with open(img_path, "rb") as f:
        img = Image.open(f).convert("RGB")
    draw = ImageDraw.Draw(img)
    for lane_i, lane in enumerate(json_line["lanes"]):
        color = _COLORMAP[lane_i % len(_COLORMAP)]
        for x, y in zip(lane, json_line["h_samples"]):
            if x != -2:
                draw.ellipse((x - 3, y - 3, x + 3, y + 3), fill=color)
    img.save(os.path.join(out_dir, f"{im_id}.jpg"))


def test_model(loader, lanenet, cfg: LaneConfig,
               gt_file: Optional[str] = None,
               save_path: Optional[str] = None,
               verbose: bool = True, use_engine: bool = False,
               stats: Optional[dict] = None) -> float:
    """Run test-set inference with `lanenet`'s weights, write
    `test_set_predictions.json`, score it with LaneEval.

    Args:
      loader: a sequential Loader over a LaneTestSet (pad_final batches;
        the predictions are sliced to `loader.num_real`).
      gt_file: the TuSimple gt label file (default test_dir/test_label.json).
      save_path: output directory (default cfg.save_path).
      use_engine: serve through `FusedLaneNetEngine` on `lanenet`'s device
        instead of `lanenet.forward`; ValueError with the learned
        homography, which the engine does not run.
      stats: if given, receives `ms_per_batch` (the mean of the batches'
        synchronized times) and `batches`.
    Returns:
      the TuSimple accuracy.
    """
    assert cfg.end_to_end, "test inference requires the end-to-end graph"
    if use_engine and cfg.learn_homography:
        raise ValueError(
            "test_model(use_engine=True) with learn_homography: the serving "
            "engine has no homography head and would fit with the fixed "
            "matrix, scoring a model other than the one trained; use "
            "use_engine=False")
    gt_file = gt_file or os.path.join(cfg.test_dir, "test_label.json")
    save_path = save_path or cfg.save_path
    mkdir_if_missing(save_path)
    test_set_file = os.path.join(save_path, "test_set_predictions.json")

    device = lanenet.fitter.sep_coeff.device
    projections = Projections(cfg.resize, cfg.order, cfg.no_mapping,
                              device=device)
    engine = packed = None
    if use_engine:
        from lanedetection_end2end_tpu_torch.models.infer_engine import (
            FusedLaneNetEngine)
        engine = FusedLaneNetEngine(cfg, device=device)
        packed = engine.prepare(lanenet.state_dict())
    infer = make_infer_fn(lanenet, cfg, projections, engine, packed)
    gt_lanes = read_json_lines(gt_file)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))

    batch_time = AverageMeter()
    preds = []
    for batch in loader:
        images = torch.from_numpy(np.ascontiguousarray(batch["image"]))
        sync()
        t0 = time.perf_counter()
        lanes_pred = infer(images)
        sync()
        batch_time.update(time.perf_counter() - t0)
        preds.append(lanes_pred.cpu().numpy())

    lanes_all = np.concatenate(preds, axis=0)[: loader.num_real]
    with open(test_set_file, "w") as json_file:
        for im_id in range(lanes_all.shape[0]):
            json_line = dict(gt_lanes[im_id])
            json_line["lanes"] = np.int_(np.round(lanes_all[im_id])).tolist()
            json_line["run_time"] = 20
            json.dump(json_line, json_file)
            json_file.write("\n")
            if cfg.draw_testset:
                _draw_test_image(json_line, cfg.test_dir, save_path, im_id)

    acc = LaneEval.bench_one_submit(test_set_file, gt_file)
    if stats is not None:
        stats.update(ms_per_batch=1e3 * batch_time.avg,
                     batches=batch_time.count)
    if verbose:
        print(acc)
        print("===> Average ACC on TESTSET is {:.8} in {:.6}s for a batch"
              .format(acc[0], batch_time.avg))
    return acc[0]
