"""Fused inference engine: the serving-path forward pass of the port.

Counterpart of `lanedetection_end2end_tpu/models/infer_engine.py`
(`FusedLaneNetEngine`, mode "full"): the same math as the e2e eval forward
of `LaneNet`, on the same weights, with the backbone running on the
hand-written kernels (`models/fused_graph.py`) and BatchNorm folded into
their constants once per checkpoint. The heads run as plain PyTorch in
bf16 on the bf16 encoder features.

Usage:
    engine = FusedLaneNetEngine(cfg)          # on the card; device="cpu"
    packed = engine.prepare(state_dict)       # once per checkpoint
    beta, line, horizon = engine(packed, images)

`state_dict` carries the reference torch names (`LaneNet(cfg).state_dict()`
or `models/port.py::state_dict_from_variables`). On a CPU device every
kernel wrapper takes its plain version.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from lanedetection_end2end_tpu_torch.config import LaneConfig
from lanedetection_end2end_tpu_torch.device import resolve_device
from lanedetection_end2end_tpu_torch.models.fused_graph import (
    decoder_fused, encoder_fused, pack_decoder, pack_encoder)
from lanedetection_end2end_tpu_torch.models.heads import Classification
from lanedetection_end2end_tpu_torch.models.lanenet import make_fitter

_HEADS = (("line_classification", "line"), ("horizon_estimation", "horizon"))


class FusedLaneNetEngine:
    def __init__(self, cfg: LaneConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fitter = make_fitter(cfg, self.device)

    def prepare(self, state_dict: Mapping[str, torch.Tensor]) -> Dict:
        """Fold BN and lay out the kernel constants on the device (once per
        checkpoint); the heads become bf16 eval modules."""
        sd = {k: v.detach().to(self.device) for k, v in state_dict.items()}
        packed = {"enc": pack_encoder(sd),
                  "dec": pack_decoder(sd, self.cfg, self.fitter)}
        if self.cfg.clas:
            for key, kind in _HEADS:
                head = Classification(kind, self.cfg.resize)
                n = len(key) + 1
                head.load_state_dict({k[n:]: v for k, v in sd.items()
                                      if k.startswith(key + ".")})
                packed[kind] = head.to(self.device, torch.bfloat16).eval()
        return packed

    @torch.no_grad()
    def __call__(self, packed: Dict, images: torch.Tensor) -> tuple:
        """images (B, H, W, 3) -> (beta (B, C, order+1) f32,
        line logits (B, 4) f32 | None, horizon logits (B, resize) f32 |
        None)."""
        enc = encoder_fused(images.to(self.device), packed["enc"])
        S = decoder_fused(enc, packed["dec"])                  # (B, H, 2C)
        C = self.cfg.out_channels
        beta = self.fitter.beta_from_rowsums(S[..., :C].transpose(1, 2),
                                             S[..., C:].transpose(1, 2))
        line = horizon = None
        if self.cfg.clas:
            e = enc.permute(0, 3, 1, 2)  # NCHW view of the NHWC features
            line = packed["line"](e).float()
            horizon = packed["horizon"](e).float()
        return beta, line, horizon
