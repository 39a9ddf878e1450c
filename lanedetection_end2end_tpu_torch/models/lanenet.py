"""LaneNet: backbone -> activation -> top-row mask -> WLS fit, plus the line
and horizon heads; the e2e forward, eval and train.

Counterpart of `lanedetection_end2end_tpu/models/lanenet.py` (`LaneNet.apply`
and `LaneNet.apply_packed` with phase="e2e"). `forward` is the plain float32
PyTorch reference that the serving engine and the packed training path are
checked against; `apply_packed` reads the same parameters and runs the
training backbone of `ops/packed_graph.py` (NB1D blocks on the fused
half-block kernels, stride-2 blocks and the e2e tail on the lane-map
kernels) in the compute dtype. The module's `state_dict` carries
the reference torch names (`net.*`, `line_classification.*`,
`horizon_estimation.*`). Only the BP profile is ported.
"""

from __future__ import annotations

import dataclasses
from math import ceil
from typing import Optional

import torch
import torch.nn as nn

from lanedetection_end2end_tpu_torch.config import LaneConfig
from lanedetection_end2end_tpu_torch.device import resolve_device
from lanedetection_end2end_tpu_torch.geometry import bev_matrices_pixel
from lanedetection_end2end_tpu_torch.models.erfnet import ERFNet
from lanedetection_end2end_tpu_torch.models.heads import Classification
from lanedetection_end2end_tpu_torch.ops.activations import activation_fn
from lanedetection_end2end_tpu_torch.ops.packed_graph import (
    erfnet_train, head_rowsums_train, resolve_fused_maps, rowsums)
from lanedetection_end2end_tpu_torch.ops.wls import WLSFitter


@dataclasses.dataclass
class LaneNetOutput:
    beta: torch.Tensor                       # (B, C, order+1)
    weightmaps: Optional[torch.Tensor]       # (B, C, H, W), masked | None
    seg_logits: Optional[torch.Tensor]       # (B, H, W, C) | None
    line_logits: Optional[torch.Tensor]      # (B, 4) | None
    horizon_logits: Optional[torch.Tensor]   # (B, resize) | None
    encoder_features: torch.Tensor           # (B, H/8, W/8, 128)


def make_fitter(cfg: LaneConfig, device) -> WLSFitter:
    if cfg.profile != "bp":
        raise NotImplementedError("the port covers the 'bp' profile only")
    M, _ = bev_matrices_pixel(cfg.resize, cfg.no_mapping)
    return WLSFitter(M, cfg.image_height, cfg.image_width, cfg.order,
                     normalized=False, reg_ls=cfg.reg_ls, device=device)


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
        self.net = ERFNet(cfg.out_channels)
        if cfg.clas:
            self.line_classification = Classification("line", cfg.resize)
            self.horizon_estimation = Classification("horizon", cfg.resize)
        self._mask = row_mask(cfg, device)
        self._act = activation_fn(cfg.activation_layer)
        self.to(device).eval()

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> LaneNetOutput:
        """images (B, H, W, 3) float -> e2e outputs, float32. `train` sets
        the modules' mode: batch statistics (running ones updated),
        gradients recorded, and Dropout2d drawn from `generator` when one
        is given; eval records no gradient."""
        self.train(train)
        with torch.set_grad_enabled(train):
            x = images.permute(0, 3, 1, 2).float()
            enc, dec = self.net(x, generator)
            dec = dec.permute(0, 2, 3, 1)                   # (B, H, W, C)
            masked = self._act(dec) * self._mask
            beta = self.fitter(masked)
            line = horizon = None
            if self.cfg.clas:
                line = self.line_classification(enc)
                horizon = self.horizon_estimation(enc)
        return LaneNetOutput(beta, masked.permute(0, 3, 1, 2), dec, line,
                             horizon, enc.permute(0, 2, 3, 1))

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
        reduces the logits."""
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
            beta = self.fitter.beta_from_rowsums(S0, S1)
            line = horizon = None
            if cfg.clas:
                e = enc.permute(0, 3, 1, 2)  # NCHW view of NHWC features
                line = _call_in_dtype(self.line_classification, e, dtype)
                horizon = _call_in_dtype(self.horizon_estimation, e, dtype)
        return LaneNetOutput(beta, None, dec, line, horizon, enc)


def _call_in_dtype(module: nn.Module, x: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """`module(x)` with its float32 parameters cast to `dtype` for the
    call (the cast is differentiable, so gradients reach the float32
    parameters); buffers stay as they are."""
    if dtype == torch.float32:
        return module(x)
    params = {k: v.to(dtype) for k, v in module.named_parameters()}
    return torch.func.functional_call(module, params, (x,))
