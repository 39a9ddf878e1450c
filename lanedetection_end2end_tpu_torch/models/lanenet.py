"""LaneNet: backbone -> activation -> top-row mask -> WLS fit, plus the line
and horizon heads; the e2e eval forward in plain PyTorch.

Counterpart of `lanedetection_end2end_tpu/models/lanenet.py` (`LaneNet.apply`
with phase="e2e", train=False). It is the float32 reference the serving
engine is checked against. The module's `state_dict` carries the reference
torch names (`net.*`, `line_classification.*`, `horizon_estimation.*`).
Only the BP profile is ported.
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
from lanedetection_end2end_tpu_torch.ops.wls import WLSFitter


@dataclasses.dataclass
class LaneNetOutput:
    beta: torch.Tensor                       # (B, C, order+1)
    weightmaps: torch.Tensor                 # (B, C, H, W), masked
    seg_logits: torch.Tensor                 # (B, H, W, C)
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
        mask = torch.ones(cfg.image_height, 1, 1, device=device)
        mask[:zero_rows(cfg)] = 0.0
        self._mask = mask                      # (H, 1, 1): over W and C
        self._act = activation_fn(cfg.activation_layer)
        self.to(device).eval()

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> LaneNetOutput:
        """images (B, H, W, 3) float -> e2e eval outputs."""
        x = images.permute(0, 3, 1, 2).float()
        enc, dec = self.net(x)
        dec = dec.permute(0, 2, 3, 1)                       # (B, H, W, C)
        masked = self._act(dec) * self._mask
        beta = self.fitter(masked)
        line = horizon = None
        if self.cfg.clas:
            line = self.line_classification(enc)
            horizon = self.horizon_estimation(enc)
        return LaneNetOutput(beta, masked.permute(0, 3, 1, 2), dec, line,
                             horizon, enc.permute(0, 2, 3, 1))
