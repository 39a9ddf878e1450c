"""The serving backbone as sequences of hand-written kernel launches.

Counterpart of `lanedetection_end2end_tpu/models/fused_graph.py`. There the
whole encoder and the whole decoder each run as ONE Pallas kernel per
image, with every intermediate plane resident in the TPU's VMEM. Here they
are the same sequences of blocks, each block one wrapper call on one
stream, with the intermediates in device memory:

- `encoder_fused`: images (B, H, W, 3) -> enc (B, H/8, W/8, 128) bf16
  through 3 K2 `downsampler` and 13 K1 `nb1d` calls;
- `decoder_fused`: enc -> S (B, H, 2C) f32 = [S0 | S1] WLS row sums through
  2 K3 `upsampler`, 4 K1 `nb1d` and 1 K4 `head_rowsums` calls; the decoder's
  full-resolution logits never reach device memory.

Fusing across blocks (a persistent kernel, or CUDA graphs to cut the 23
launches' overhead) is later work.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from lanedetection_end2end_tpu_torch.config import LaneConfig
from lanedetection_end2end_tpu_torch.models.erfnet import ENC_DILATIONS
from lanedetection_end2end_tpu_torch.models.lanenet import zero_rows
from lanedetection_end2end_tpu_torch.ops.backbone import (
    downsampler, head_rowsums, pack_downsampler, pack_head, pack_upsampler,
    upsampler)
from lanedetection_end2end_tpu_torch.ops.nb1d import nb1d, pack_nb1d
from lanedetection_end2end_tpu_torch.ops.wls import WLSFitter

_ENC = "net.encoder"
_DEC = "net.decoder"


def pack_encoder(sd: Mapping[str, torch.Tensor]) -> Dict:
    """Folded kernel constants of the encoder (reference torch names)."""
    return {
        "initial": pack_downsampler(sd, f"{_ENC}.initial_block"),
        "down1": pack_downsampler(sd, f"{_ENC}.layers.0"),
        "nb64": [pack_nb1d(sd, f"{_ENC}.layers.{1 + i}", d)
                 for i, d in enumerate(ENC_DILATIONS[:5])],
        "down2": pack_downsampler(sd, f"{_ENC}.layers.6"),
        "nb128": [pack_nb1d(sd, f"{_ENC}.layers.{7 + i}", d)
                  for i, d in enumerate(ENC_DILATIONS[5:])],
    }


def encoder_fused(images: torch.Tensor, packed: Dict) -> torch.Tensor:
    """images (B, H, W, 3) -> encoder features (B, H/8, W/8, 128) bf16."""
    x = images.to(torch.bfloat16).contiguous()
    x = downsampler(x, packed["initial"])
    x = downsampler(x, packed["down1"])
    for p in packed["nb64"]:
        x = nb1d(x, p)
    x = downsampler(x, packed["down2"])
    for p in packed["nb128"]:
        x = nb1d(x, p)
    return x


def pack_decoder(sd: Mapping[str, torch.Tensor], cfg: LaneConfig,
                 fitter: WLSFitter) -> Dict:
    """Folded kernel constants of the decoder, the head and the row-sum
    tail (column coordinate, mask rows, activation)."""
    return {
        "up1": pack_upsampler(sd, f"{_DEC}.layers.0"),
        "nb64": [pack_nb1d(sd, f"{_DEC}.layers.{i}", 1) for i in (1, 2)],
        "up2": pack_upsampler(sd, f"{_DEC}.layers.3"),
        "nb16": [pack_nb1d(sd, f"{_DEC}.layers.{i}", 1) for i in (4, 5)],
        "head": pack_head(sd, f"{_DEC}.output_conv", fitter.sep_xs,
                          zero_rows(cfg), cfg.activation_layer),
    }


def decoder_fused(enc: torch.Tensor, packed: Dict) -> torch.Tensor:
    """enc (B, H/8, W/8, 128) bf16 -> S (B, H, 2C) f32 WLS row sums
    [S0 | S1]."""
    t = upsampler(enc, packed["up1"])
    for p in packed["nb64"]:
        t = nb1d(t, p)
    t = upsampler(t, packed["up2"])
    for p in packed["nb16"]:
        t = nb1d(t, p)
    return head_rowsums(t, packed["head"])
