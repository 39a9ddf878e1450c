"""The train and eval steps, one per (profile, phase).

Counterpart of `lanedetection_end2end_tpu/train/steps.py`, for both
profiles and the three phases of the staged schedule:

- 'skip': the weighted per-pixel cross entropy of the segmentation
  logits alone, no fit;
- 'seg': the same cross entropy drives the gradients; the fit of the
  argmax maps gives the curve loss as a detached metric (`rmse` in the BP
  profile, `area_sq` in the BEV one);
- 'e2e': the curve loss, plus the line and horizon heads' losses with
  `clas`, end to end.

The curve loss is the backprojection MSE averaged over the lanes ('bp'),
or the area loss or the parameter MSE of lanes 0 and 1, and of lanes 2
and 3 with four lanes, the MSE masking an absent outer lane ('bev',
`loss_policy`). The BEV profile also reports the exact trapezoidal area
of the two ego lanes (`exact_area`), its line head is four 3-way
classifiers (cross entropy; argmax accuracy), and its segmentation
classes are weighted [1, w, w] (BP: [1] + [w] * nclasses). As in the
JAX package, skip and seg run on the plain float32 graph
(`LaneNet.forward`, cuDNN and autograd; no kernel of the port), and e2e on
the training backbone (`LaneNet.apply_packed`, K6-K10 on a card), except
where the packed path does not serve the config (the learned homography)
or `packed_train` is False: then e2e runs on `LaneNet.forward` too, as
JAX runs it on its flax graph (`resolve_packed`; a forced True there
raises). With the learned
homography the backprojection loss takes each sample's matrices
(`BackprojectionLoss.with_M`). Every metric stays on the device. A mesh
of devices is not ported yet.

    step = make_train_step(lanenet, cfg, optimizer, phase)  # on the card
    metrics = step(batch, generator)                  # one optimizer step

`batch` is a dict of tensors (any device): `image` (B, H, W, 3) uint8 or
float, optionally `flip` (B,) bool; 'bp': `lanes` and `valid_points` (B,
nclasses, 56), `line` (B, 4); 'bev': `params` (B, 4, 3), `line` (B, 4)
class indices; both: `horizon` (B, resize), and `gt` (B, H, W) for skip
and seg. `generator` is the `torch.Generator` (on the step's device) that
dropout draws from; None turns dropout off.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from lanedetection_end2end_tpu_torch.config import LaneConfig
from lanedetection_end2end_tpu_torch.device import resolve_device
from lanedetection_end2end_tpu_torch.models.lanenet import PHASES
from lanedetection_end2end_tpu_torch.ops.losses import (
    BackprojectionLoss, area_loss, bce_with_logits, cross_entropy_logits,
    mse_params_loss, weighted_cross_entropy)
from lanedetection_end2end_tpu_torch.ops.metrics import trapezoidal_area
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


def seg_class_weights(cfg: LaneConfig, device=None) -> torch.Tensor:
    """The segmentation classes' weights: 'bev' [1, w, w], 'bp' [1] + [w]
    * nclasses, w = `weight_seg`."""
    w = cfg.weight_seg
    vals = [1.0, w, w] if cfg.profile == "bev" else [1.0] + [w] * cfg.nclasses
    return torch.tensor(vals, dtype=torch.float32, device=device)


def _lane_present(gt_params: torch.Tensor) -> torch.Tensor:
    """(B,) 1.0 where no gt coefficient is 0."""
    return (gt_params != 0).all(dim=-1).float()


def _pad_order2(beta: torch.Tensor) -> torch.Tensor:
    """Coefficients as [a, b, c] for the order-2 area metric: left-padded
    with zeros, or the last three of a higher order."""
    pad = 3 - beta.shape[-1]
    if pad > 0:
        return torch.cat([beta.new_zeros(*beta.shape[:-1], pad), beta], -1)
    return beta[..., -3:]


def resolve_packed(lanenet, cfg: LaneConfig, phase: str) -> bool:
    """Whether `phase` trains on the packed backbone: the e2e phase where
    `LaneNet.packed_supported` allows it, unless `cfg.packed_train` is
    False (None, the default, selects it where it serves). The skip and
    seg phases have no packed path and run `LaneNet.forward` whatever the
    flag says. A forced True on an e2e config that the packed path does
    not serve raises ValueError, where the JAX package's `_resolve_packed`
    warns and runs its flax graph: the port gives no kernel's work to the
    plain graph unasked."""
    if phase != "e2e" or cfg.packed_train is False:
        return False
    supported = lanenet.packed_supported(phase)
    if cfg.packed_train and not supported:
        raise ValueError(
            "packed_train=True was forced but the packed backbone does not "
            "serve this configuration (the learned homography or a "
            "non-separable homography; LaneNet.packed_supported): leave "
            "packed_train unset or set it False to train e2e on "
            "LaneNet.forward")
    return supported


def make_loss_fn(lanenet, cfg: LaneConfig, phase: str = "e2e",
                 train: bool = True, fused_blocks: bool = True,
                 fused_maps: Optional[bool] = None) -> Callable:
    """Returns loss_fn(batch, generator) -> (loss, metrics, outputs) on
    `lanenet` (a `models/lanenet.py::LaneNet`) for `phase`.

    The e2e phase runs the training backbone of `LaneNet.apply_packed` in
    `cfg.compute_dtype`. `fused_blocks` (default True, JAX
    `PACKED_FUSED_BLOCKS=1`) runs the NB1D blocks on the fused half-block
    kernels, False on K11's single convolutions. `fused_maps` (None: as
    `fused_blocks`, JAX's rule; True is the JAX default
    `PACKED_FUSED_MAPS=1`) runs the stride-2 blocks and the tail on the
    lane-map kernels; False is `PACKED_FUSED_MAPS=0`. Every kernel of
    every path takes bf16 and float32 planes on the card, so both dtypes
    train there with any `fused_blocks` and `fused_maps`. The cuDNN
    convolutions (the stride-2 blocks with `fused_maps=False`, the heads)
    follow PyTorch's TF32 flags, which the step leaves as they are.

    The skip and seg phases run `LaneNet.forward` (float32, PyTorch
    autograd), as the JAX package runs them on its flax graph; the
    keywords of the packed path do not apply there. They need a
    segmentation head with the background channel (`pretrained`, or
    `end_to_end` off): ValueError otherwise. So does the e2e phase where
    `resolve_packed` says no (the learned homography, `packed_train`
    False); there the backprojection loss takes the per-sample matrices
    of the forward when it gives them."""
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}")
    device = lanenet.fitter.sep_coeff.device
    bev = cfg.profile == "bev"
    seg_weights = seg_class_weights(cfg, device)
    seg_channels = (cfg.nclasses + 1 if cfg.pretrained
                    else cfg.seg_out_channels)
    if phase != "e2e" and seg_channels != seg_weights.shape[0]:
        raise ValueError(
            f"segmentation head has {seg_channels} channels but "
            f"{seg_weights.shape[0]} classes are expected: seg-phase "
            "training needs the background channel (configure "
            "pretrained=True for the dual head, or end_to_end=False)")
    if not bev:
        criterion = BackprojectionLoss(cfg.resize, cfg.order, cfg.no_mapping,
                                       device=device)
    dtype = _DTYPES[cfg.compute_dtype]
    packed = resolve_packed(lanenet, cfg, phase)

    def curve_loss_bev(beta, gt_params):
        """Area or parameter MSE over the lanes, the MSE masking absent
        outer lanes."""
        loss = 0.0
        for k in range(cfg.nclasses):
            if cfg.loss_policy == "area":
                loss = loss + area_loss(beta[:, k], gt_params[:, k],
                                        order=cfg.order,
                                        weight_funct=cfg.weight_funct)
            elif k < 2:
                loss = loss + mse_params_loss(beta[:, k], gt_params[:, k])
            else:
                mask = _lane_present(gt_params[:, k])[:, None]
                loss = loss + mse_params_loss(beta[:, k] * mask,
                                              gt_params[:, k])
        return loss

    def curve_loss_bp(beta, lanes, valid_points, M_b=None, M_inv_b=None):
        """Backprojection MSE summed over the lanes / nclasses; with the
        learned homography, on each sample's own matrices."""
        loss, x_cal = 0.0, []
        for k in range(cfg.nclasses):
            if M_b is not None:
                lk, xk = criterion.with_M(beta[:, k], lanes[:, k],
                                          valid_points[:, k], M_b, M_inv_b)
            else:
                lk, xk = criterion(beta[:, k], lanes[:, k],
                                   valid_points[:, k])
            loss = loss + lk
            x_cal.append(xk)
        return loss / cfg.nclasses, torch.stack(x_cal, dim=1)

    def loss_fn(batch, generator=None):
        batch = prepare_batch(batch)
        if packed:
            out = lanenet.apply_packed(batch["image"], train=train,
                                       generator=generator, dtype=dtype,
                                       fused_blocks=fused_blocks,
                                       fused_maps=fused_maps)
        else:
            out = lanenet.forward(batch["image"], phase=phase, train=train,
                                  generator=generator)
        metrics: Dict[str, torch.Tensor] = {}
        outputs: Dict[str, torch.Tensor] = {}

        if phase == "skip":
            loss = weighted_cross_entropy(out.seg_logits, batch["gt"],
                                          seg_weights)
            metrics["loss"] = loss.detach()
            return loss, metrics, outputs

        beta = out.beta
        outputs["beta"] = beta
        if bev:
            gt_params = batch["params"]
            curve = curve_loss_bev(beta, gt_params)
            with torch.no_grad():
                tl = trapezoidal_area(_pad_order2(beta[:, 0]),
                                      _pad_order2(gt_params[:, 0]))
                tr = trapezoidal_area(_pad_order2(beta[:, 1]),
                                      _pad_order2(gt_params[:, 1]))
                metrics["exact_area"] = ((tl + tr) / 2.0).mean()
        else:
            curve, outputs["x_cal"] = curve_loss_bp(
                beta, batch["lanes"], batch["valid_points"], out.M,
                out.M_inv)
        if phase == "e2e":
            loss = curve
        else:
            loss = weighted_cross_entropy(out.seg_logits, batch["gt"],
                                          seg_weights)
            metrics["area_sq" if bev else "rmse"] = curve.detach()

        if cfg.clas and phase == "e2e":
            if bev:  # four 3-way line-type heads
                loss_line = cross_entropy_logits(out.line_logits,
                                                 batch["line"])
            else:
                loss_line = bce_with_logits(out.line_logits, batch["line"])
            loss_horizon = bce_with_logits(out.horizon_logits,
                                           batch["horizon"])
            loss = (loss * cfg.weight_fit
                    + (loss_line + loss_horizon) * cfg.weight_class)
            with torch.no_grad():
                if bev:
                    line_pred = out.line_logits.argmax(dim=1)
                else:
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
                    fused_maps: Optional[bool] = None,
                    state: Optional[TrainState] = None) -> Callable:
    """Returns step(batch, generator) -> metrics: one forward, backward and
    optimizer update of `lanenet` in place. Runs on the card unless
    `device="cpu"`; `lanenet` must live on that device. `step.state`
    is the `TrainState` (model, optimizer, steps taken): `state` where
    given, else a new one. `phase`, `fused_blocks` and `fused_maps` as
    in `make_loss_fn`."""
    device = resolve_device(device)
    loss_fn = make_loss_fn(lanenet, cfg, phase, train=True,
                           fused_blocks=fused_blocks, fused_maps=fused_maps)
    if state is None:
        state = TrainState(lanenet, optimizer)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch, generator: Optional[torch.Generator] = None):
        optimizer.zero_grad(set_to_none=True)
        loss, metrics, _ = loss_fn(_to_device(batch, device), generator)
        loss.backward()
        # a parameter the phase does not reach (the heads in skip and seg,
        # the head the phase does not read) takes a zero gradient for the
        # update, as it does in JAX, so its moments and step count move
        # with the rest; its .grad stays None for the caller
        unused = [p for p in params if p.grad is None]
        for p in unused:
            p.grad = torch.zeros_like(p)
        optimizer.step()
        for p in unused:
            p.grad = None
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
