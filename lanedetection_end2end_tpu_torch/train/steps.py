"""The e2e train and eval steps.

Counterpart of `lanedetection_end2end_tpu/train/steps.py` for the BP
profile, phase 'e2e': the backprojection curve loss plus the line and
horizon heads' losses, end to end. The loss assembly and the metrics follow
the JAX package: per-lane backprojection MSE averaged over the lanes,
`loss * weight_fit + (loss_line + loss_horizon) * weight_class`, and every
metric computed on the device. The phases 'skip' and 'seg', the BEV branch
and a mesh of devices are not ported yet.

    step = make_train_step(lanenet, cfg, optimizer)   # on the card
    metrics = step(batch, generator)                  # one optimizer step

`batch` is a dict of tensors (any device): `image` (B, H, W, 3) uint8 or
float, `lanes` and `valid_points` (B, nclasses, 56), `line` (B, 4),
`horizon` (B, resize), optionally `flip` (B,) bool. `generator` is the
`torch.Generator` (on the step's device) that dropout draws from; None
turns dropout off.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from lanedetection_end2end_tpu_torch.config import LaneConfig
from lanedetection_end2end_tpu_torch.device import resolve_device
from lanedetection_end2end_tpu_torch.ops.losses import (
    BackprojectionLoss, bce_with_logits)
from lanedetection_end2end_tpu_torch.train.state import TrainState

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def prepare_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Device-side batch preparation for compact-transfer batches: applies
    the per-sample horizontal mirror (`flip`: the image ships unflipped,
    the small labels were mirrored on the host), widens uint8 images to
    f32 in [0, 1] and uint8 gt to int64. Float batches pass through."""
    out = dict(batch)
    img = out["image"]
    flip = out.pop("flip", None)
    if flip is not None:
        img = torch.where(flip[:, None, None, None], img.flip(2), img)
    if img.dtype == torch.uint8:
        img = img.float() * (1.0 / 255.0)
    out["image"] = img
    if "gt" in out and out["gt"].dtype != torch.int64:
        out["gt"] = out["gt"].long()
    return out


def make_loss_fn(lanenet, cfg: LaneConfig, phase: str = "e2e",
                 train: bool = True, fused_blocks: bool = True,
                 fused_maps: Optional[bool] = None) -> Callable:
    """Returns loss_fn(batch, generator) -> (loss, metrics, outputs) on
    `lanenet` (a `models/lanenet.py::LaneNet`), through the training
    backbone of `LaneNet.apply_packed` in `cfg.compute_dtype`.
    `fused_blocks` (default True, JAX `PACKED_FUSED_BLOCKS=1`) runs the
    NB1D blocks on the fused half-block kernels, False on K11's single
    convolutions. `fused_maps` (None: as `fused_blocks`, JAX's rule;
    True is the JAX default `PACKED_FUSED_MAPS=1`) runs the stride-2
    blocks and the tail on the lane-map kernels; False is
    `PACKED_FUSED_MAPS=0`.

    On the card, a float32 step needs `fused_blocks=False` (with
    `fused_maps` False, as None gives it): K11 and `channel_sums` have
    float32 kernels, the fused kernels K6-K10 do not yet, and they raise
    on a float32 plane. The cuDNN convolutions of that path (stride-2
    blocks, heads) follow PyTorch's TF32 flags, which the step leaves as
    they are."""
    if phase != "e2e" or cfg.profile != "bp":
        raise NotImplementedError(
            "the port trains the 'bp' profile in phase 'e2e' only")
    device = lanenet.fitter.sep_coeff.device
    criterion = BackprojectionLoss(cfg.resize, cfg.order, cfg.no_mapping,
                                   device=device)
    dtype = _DTYPES[cfg.compute_dtype]

    def loss_fn(batch, generator=None):
        batch = prepare_batch(batch)
        out = lanenet.apply_packed(batch["image"], train=train,
                                   generator=generator, dtype=dtype,
                                   fused_blocks=fused_blocks,
                                   fused_maps=fused_maps)
        metrics: Dict[str, torch.Tensor] = {}
        outputs: Dict[str, torch.Tensor] = {"beta": out.beta}

        # backprojection MSE summed over the lanes / nclasses
        loss, x_cal = 0.0, []
        for k in range(cfg.nclasses):
            lk, xk = criterion(out.beta[:, k], batch["lanes"][:, k],
                               batch["valid_points"][:, k])
            loss = loss + lk
            x_cal.append(xk)
        loss = loss / cfg.nclasses
        outputs["x_cal"] = torch.stack(x_cal, dim=1)

        if cfg.clas:
            loss_line = bce_with_logits(out.line_logits, batch["line"])
            loss_horizon = bce_with_logits(out.horizon_logits,
                                           batch["horizon"])
            loss = (loss * cfg.weight_fit
                    + (loss_line + loss_horizon) * cfg.weight_class)
            with torch.no_grad():
                line_pred = torch.round(torch.sigmoid(out.line_logits))
                horizon_pred = torch.round(torch.sigmoid(out.horizon_logits))
                metrics["loss_line"] = loss_line.detach()
                metrics["loss_horizon"] = loss_horizon.detach()
                metrics["acc_line"] = (
                    line_pred == batch["line"]).float().mean()
                metrics["acc_horizon"] = (
                    horizon_pred == batch["horizon"]).float().mean()
            outputs["line_pred"] = line_pred
            outputs["horizon_pred"] = horizon_pred
        metrics["loss"] = loss.detach()
        return loss, metrics, outputs

    return loss_fn


def _to_device(batch, device):
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def make_train_step(lanenet, cfg: LaneConfig,
                    optimizer: torch.optim.Optimizer, phase: str = "e2e",
                    device=None, fused_blocks: bool = True,
                    fused_maps: Optional[bool] = None) -> Callable:
    """Returns step(batch, generator) -> metrics: one forward, backward and
    optimizer update of `lanenet` in place. Runs on the card unless
    `device="cpu"`; `lanenet` must live on that device. `step.state`
    is the `TrainState` (model, optimizer, steps taken). `fused_blocks`
    and `fused_maps` as in `make_loss_fn`."""
    device = resolve_device(device)
    loss_fn = make_loss_fn(lanenet, cfg, phase, train=True,
                           fused_blocks=fused_blocks, fused_maps=fused_maps)
    state = TrainState(lanenet, optimizer)

    def step(batch, generator: Optional[torch.Generator] = None):
        optimizer.zero_grad(set_to_none=True)
        loss, metrics, _ = loss_fn(_to_device(batch, device), generator)
        loss.backward()
        optimizer.step()
        state.step += 1
        return metrics

    step.state = state
    return step


def make_eval_step(lanenet, cfg: LaneConfig, phase: str = "e2e",
                   device=None, fused_blocks: bool = True,
                   fused_maps: Optional[bool] = None) -> Callable:
    """Returns step(batch) -> (metrics, outputs): no gradients, running
    BatchNorm statistics, no dropout."""
    device = resolve_device(device)
    loss_fn = make_loss_fn(lanenet, cfg, phase, train=False,
                           fused_blocks=fused_blocks, fused_maps=fused_maps)

    def step(batch):
        with torch.no_grad():
            _, metrics, outputs = loss_fn(_to_device(batch, device))
        return metrics, outputs

    return step
