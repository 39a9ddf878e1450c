"""LaneNet: backbone -> activation -> top-row mask -> WLS fit, plus the line
and horizon heads, for both profiles and the three phases.

Counterpart of `lanedetection_end2end_tpu/models/lanenet.py` (`LaneNet.apply`
and `LaneNet.apply_packed`). `forward` is the plain PyTorch graph, in
float32 (the reference that the serving engine and the packed training
path are checked against) or in the compute dtype the steps pass (the
graph the skip and seg phases train on, as the JAX package trains them on
its flax graph in its `LaneNet(cfg, dtype)`). In bf16 it casts as flax's
`dtype=` does: each convolution and linear layer takes its input, weight
and bias in bf16, each BatchNorm takes its statistics in float32 and
returns bf16, the parameters stay float32, and the logits are widened to
float32 before the activation, the mask and the fit. The phases:

- 'e2e': activation of the logits -> row mask -> WLS fit, and the heads;
- 'seg': the detached argmax of the logits split into per-lane maps
  carrying the class index as weight (k * [argmax == k], k = 1..nclasses)
  -> row mask -> WLS fit (a metric only); the heads still run, and in
  train mode update their BatchNorm statistics, but are not returned;
- 'skip': the logits alone, no fit (the heads as in 'seg').

With `pretrained`, the decoder carries the pretraining head `output_conv2`
(nclasses + 1 channels) beside the main one: 'e2e' reads the main head,
'skip' and 'seg' the pretraining head. `apply_packed` is the e2e phase on
the training backbone of `ops/packed_graph.py` (NB1D blocks on the fused
half-block kernels, stride-2 blocks and the e2e tail on the lane-map
kernels) in the compute dtype, for either profile: the fitter of both is
separable ('bp': pixel coordinates; 'bev': the normalized homography). The
module's `state_dict` carries the reference torch names (`net.*`,
`line_classification.*`, `horizon_estimation.*`).

With `learn_homography` (BP profile), the module also holds
`homography_head` (`models/dlt.py`): in the e2e phase its offsets give
each sample its own matrices (`geometry/dlt.py::dlt_homography`), whose
coefficient rows (`WLSFitter.sep_coeff_from_M`) the fit contracts with
the row sums (`WLSFitter.beta_from_rowsums_per_sample`), and the output
carries them as `M` and `M_inv`. The matrices are row-separable, so the
fit still needs only the row sums: `apply_packed` takes them from the
training tail's kernels as it does for the fixed matrix, and trains this
option on K6-K10 too, where the JAX package trains it on its flax graph.
The head, the DLT and the coefficient rows run under the
`model.homography` span on both graphs. The head runs in every phase (in
train mode its BatchNorm statistics move), as the line and horizon heads
do. ERFNet's dormant `do_segmentation` decoder is never turned on here,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from math import ceil
from typing import Optional

import torch
import torch.nn as nn

from lanedetection_end2end_tpu_torch.config import LaneConfig
from lanedetection_end2end_tpu_torch.device import resolve_device
from lanedetection_end2end_tpu_torch.geometry import (
    bev_matrices_normalized, bev_matrices_pixel, dlt_homography)
from lanedetection_end2end_tpu_torch.models.dlt import HomographyHead
from lanedetection_end2end_tpu_torch.models.erfnet import (
    ERFNet, call_in_dtype)
from lanedetection_end2end_tpu_torch.models.heads import Classification
from lanedetection_end2end_tpu_torch.ops.activations import activation_fn
from lanedetection_end2end_tpu_torch.ops.packed_graph import (
    erfnet_train, head_rowsums_train, resolve_fused_maps, rowsums)
from lanedetection_end2end_tpu_torch.ops.wls import WLSFitter
from lanedetection_end2end_tpu_torch.utils.profiling import span


PHASES = ("skip", "seg", "e2e")


@dataclasses.dataclass
class LaneNetOutput:
    beta: Optional[torch.Tensor]             # (B, C, order+1) | None (skip)
    weightmaps: Optional[torch.Tensor]       # (B, C, H, W), masked | None
    seg_logits: Optional[torch.Tensor]       # (B, H, W, C) | None
    line_logits: Optional[torch.Tensor]      # (B, 4) bp | (B, 3, 4) bev | None
    horizon_logits: Optional[torch.Tensor]   # (B, resize) | None
    encoder_features: torch.Tensor           # (B, H/8, W/8, 128)
    # learned homography only: the per-sample matrices of the e2e fit
    M: Optional[torch.Tensor] = None         # (B, 3, 3)
    M_inv: Optional[torch.Tensor] = None     # (B, 3, 3)


def make_fitter(cfg: LaneConfig, device) -> WLSFitter:
    """The profile's fitter: 'bev' on the normalized homography in
    normalized coordinates, 'bp' on the pixel one in pixels."""
    if cfg.profile == "bev":
        M, _ = bev_matrices_normalized()
    else:
        M, _ = bev_matrices_pixel(cfg.resize, cfg.no_mapping)
    return WLSFitter(M, cfg.image_height, cfg.image_width, cfg.order,
                     normalized=cfg.profile == "bev", reg_ls=cfg.reg_ls,
                     device=device, use_pallas=cfg.use_pallas_wls)


def zero_rows(cfg: LaneConfig) -> int:
    """Rows [0, ceil(resize * mask_percentage)) carry no fit weight."""
    return ceil(cfg.resize * cfg.mask_percentage)


def row_mask(cfg: LaneConfig, device) -> torch.Tensor:
    """(H, 1, 1) float32: 0 on the top `zero_rows` rows, 1 below; it
    broadcasts over W and C of (B, H, W, C) weight maps."""
    mask = torch.ones(cfg.image_height, 1, 1, device=device)
    mask[:zero_rows(cfg)] = 0.0
    return mask


class LaneNet(nn.Module):
    """The reference `Net`: ERFNet + heads, with the WLS fitter and the row
    mask as constants on `device`."""

    def __init__(self, cfg: LaneConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.fitter = make_fitter(cfg, device)
        self.net = ERFNet(cfg.out_channels, cfg.pretrained)
        if cfg.clas:
            self.line_classification = Classification("line", cfg.resize,
                                                      cfg.profile)
            self.horizon_estimation = Classification("horizon", cfg.resize,
                                                     cfg.profile)
        if cfg.learn_homography:
            self.homography_head = HomographyHead()
        self._mask = row_mask(cfg, device)
        self._act = activation_fn(cfg.activation_layer)
        self.to(device).eval()

    def forward(self, images: torch.Tensor, phase: str = "e2e",
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.float32) -> LaneNetOutput:
        """images (B, H, W, 3) float -> the outputs of `phase`. `train`
        sets the modules' mode: batch statistics (running ones updated),
        gradients recorded, and Dropout2d drawn from `generator` when one
        is given; eval records no gradient. `dtype` is the compute dtype
        of the backbone and the heads (`models/erfnet.py::call_in_dtype`):
        the encoder features and the line and horizon logits come out in
        it, the segmentation logits, the weight maps, beta and the
        matrices in float32."""
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r}")
        cfg = self.cfg
        use_main = phase == "e2e" or not cfg.pretrained
        self.train(train)
        with torch.set_grad_enabled(train):
            x = images.permute(0, 3, 1, 2).float()
            enc, dec, _ = call_in_dtype(self.net, dtype, x, generator,
                                         use_main_head=use_main)
            dec = dec.permute(0, 2, 3, 1).float()           # (B, H, W, C)
            line = horizon = None
            if cfg.clas:
                line = call_in_dtype(self.line_classification, dtype, enc)
                horizon = call_in_dtype(self.horizon_estimation, dtype, enc)
            M_b = M_inv_b = coeff = None
            if cfg.learn_homography:
                M_b, M_inv_b, coeff = self._homography(enc, dtype,
                                                       phase == "e2e")
            enc = enc.permute(0, 2, 3, 1)
            if phase == "skip":
                return LaneNetOutput(None, None, dec, None, None, enc)
            if phase == "e2e":
                activated = self._act(dec)
            else:
                # the heads feed losses in the e2e phase only
                am = dec.detach().argmax(dim=-1)            # (B, H, W)
                activated = torch.stack(
                    [(am == k).float() * k
                     for k in range(1, cfg.nclasses + 1)], dim=-1)
                line = horizon = None
            masked = activated * self._mask
            if coeff is not None:
                beta = self.fitter.beta_from_rowsums_per_sample(
                    *self.fitter.rowsums(masked), coeff)
            else:
                beta = self.fitter(masked)
        return LaneNetOutput(beta, masked.permute(0, 3, 1, 2), dec, line,
                             horizon, enc, M_b, M_inv_b)

    def _homography(self, enc: torch.Tensor, dtype: torch.dtype,
                    fit: bool) -> tuple:
        """The learned homography's head on the encoder features `enc`
        (B, 128, H/8, W/8) in `dtype`, under the `model.homography` span,
        and with `fit` each sample's geometry: -> (M, M_inv, the fit's
        coefficient rows (B, 2H, K)), or three Nones without `fit`."""
        with span("model.homography", self._mask.device):
            offsets = call_in_dtype(self.homography_head, dtype, enc)
            if not fit:
                return None, None, None
            M_b, M_inv_b = dlt_homography(offsets, self.cfg.resize)
            return M_b, M_inv_b, self.fitter.sep_coeff_from_M(M_b)

    def packed_supported(self, phase: str) -> bool:
        """Whether `apply_packed` serves this config and phase: the e2e
        phase with a separable fitter (the learned homography's matrices
        are row-separable, so it is served too)."""
        return phase == "e2e" and bool(self.fitter.separable)

    def apply_packed(self, images: torch.Tensor, train: bool = False,
                     generator: Optional[torch.Generator] = None,
                     dtype: torch.dtype = torch.float32,
                     fused_blocks: bool = True,
                     fused_maps: Optional[bool] = None) -> LaneNetOutput:
        """The e2e forward on the training backbone: same parameters, same
        math as `forward`, with the backbone in `dtype` on NHWC planes
        (`ops/packed_graph.py::erfnet_train`), the fit from the row sums of
        the f32 logits, and the heads in `dtype` on the encoder features.
        The weight maps are never formed (`weightmaps` is None).

        `fused_blocks` (default True, JAX `PACKED_FUSED_BLOCKS=1`) runs
        the NB1D blocks on the fused half-block kernels, False on K11's
        single convolutions (`ops/packed_graph.py`). `fused_maps` (None:
        as `fused_blocks`, the JAX package's rule) runs the stride-2
        blocks on the lane-map kernels and, in train mode with the square
        activation, fuses the head with the tail: the logits are never
        formed either (`seg_logits` is None). In eval mode, or with
        another activation, the head runs on its own and `rowsums`
        reduces the logits.

        With the learned homography its head runs beside the line and
        horizon heads, and the fit contracts the same row sums with each
        sample's coefficient rows; `M` and `M_inv` are returned as
        `forward` returns them."""
        if not self.packed_supported("e2e"):
            raise ValueError("apply_packed: the packed path does not serve "
                             "this config (a non-separable homography)")
        self.train(train)
        cfg = self.cfg
        fused_maps = resolve_fused_maps(fused_blocks, fused_maps)
        fuse_tail = (fused_maps and train
                     and cfg.activation_layer == "square")
        with torch.set_grad_enabled(train):
            enc, dec = erfnet_train(self.net, images, train=train,
                                    generator=generator, dtype=dtype,
                                    fused_blocks=fused_blocks,
                                    fused_maps=fused_maps,
                                    skip_head=fuse_tail)
            if fuse_tail:
                S0, S1 = head_rowsums_train(
                    dec, self.net.decoder.output_conv, self.fitter.sep_xs,
                    zero_rows(cfg))
                dec = None
            else:
                S0, S1 = rowsums(dec, self._act, self.fitter.sep_xs,
                                 zero_rows(cfg))
            M_b = M_inv_b = None
            if cfg.learn_homography:
                M_b, M_inv_b, coeff = self._homography(
                    enc.permute(0, 3, 1, 2), dtype, True)
                beta = self.fitter.beta_from_rowsums_per_sample(S0, S1,
                                                                coeff)
            else:
                beta = self.fitter.beta_from_rowsums(S0, S1)
            line = horizon = None
            if cfg.clas:
                e = enc.permute(0, 3, 1, 2)  # NCHW view of NHWC features
                line = call_in_dtype(self.line_classification, dtype, e)
                horizon = call_in_dtype(self.horizon_estimation, dtype, e)
        return LaneNetOutput(beta, None, dec, line, horizon, enc, M_b,
                             M_inv_b)
