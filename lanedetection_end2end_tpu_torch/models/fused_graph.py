"""The serving backbone: the whole encoder and the whole decoder, one
cooperative launch each.

Counterpart of `lanedetection_end2end_tpu/models/fused_graph.py`. There the
whole encoder and the whole decoder each run as ONE Pallas kernel per
image, with every intermediate plane resident in the TPU's VMEM. Here each
is ONE cooperative launch on the card (`ops/backbone_fused.py`), a
persistent grid that walks the blocks' passes with a grid-wide barrier
between each pair and keeps the planes in device memory (L2 at batch 8):

- `encoder_fused`: images (B, H, W, 3) -> enc (B, H/8, W/8, 128) bf16
  (`csrc/encoder_fused.cu`: the 3 downsamplers and 13 NB1D blocks);
- `decoder_fused`: enc -> S (B, H, 2C) f32 = [S0 | S1] WLS row sums
  (`csrc/decoder_fused.cu`: 2 upsamplers, 4 NB1D blocks and the head with
  activation and row mask); the decoder's full-resolution logits never
  reach device memory.

A CPU tensor takes the plain versions; a CUDA tensor runs the fused
kernels or raises. `encoder_blocks` / `decoder_blocks` are the same
sequences as 23 wrapper calls of K1-K4 (40 launches), whose device code
the fused kernels run: they are the bit-for-bit reference of the fused
kernels on the card, and nothing on the serving path calls them. JAX's
`NB1D_STACK` knob (images stacked per grid step for the MXU's M dimension)
has no counterpart: the CUDA tiles already span images.
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
from lanedetection_end2end_tpu_torch.ops.backbone_fused import (
    DEC_STAGES, ENC_STAGES, decoder_fused_kernel, decoder_plain,
    encoder_fused_kernel, encoder_plain, flat_constants, run_stages)
from lanedetection_end2end_tpu_torch.ops.nb1d import nb1d, pack_nb1d
from lanedetection_end2end_tpu_torch.ops.wls import WLSFitter

_ENC = "net.encoder"
_DEC = "net.decoder"
# the blocks' wrappers by stage kind: the block sequence
BLOCKS = {"down": downsampler, "up": upsampler, "nb1d": nb1d,
          "head": head_rowsums}


def pack_encoder(sd: Mapping[str, torch.Tensor]) -> Dict:
    """Folded kernel constants of the encoder (reference torch names): the
    per-block dicts of K1/K2 and, laid out from them once, the fused
    kernel's `wbuf`, `vbuf` and offset `table`."""
    packed = {
        "initial": pack_downsampler(sd, f"{_ENC}.initial_block"),
        "down1": pack_downsampler(sd, f"{_ENC}.layers.0"),
        "nb64": [pack_nb1d(sd, f"{_ENC}.layers.{1 + i}", d)
                 for i, d in enumerate(ENC_DILATIONS[:5])],
        "down2": pack_downsampler(sd, f"{_ENC}.layers.6"),
        "nb128": [pack_nb1d(sd, f"{_ENC}.layers.{7 + i}", d)
                  for i, d in enumerate(ENC_DILATIONS[5:])],
    }
    packed.update(flat_constants(packed, ENC_STAGES))
    return packed


def encoder_fused(images: torch.Tensor, packed: Dict) -> torch.Tensor:
    """images (B, H, W, 3) -> encoder features (B, H/8, W/8, 128) bf16."""
    x = images.to(torch.bfloat16).contiguous()
    if x.device.type == "cpu":
        return encoder_plain(x, packed)
    return encoder_fused_kernel(x, packed)


def encoder_blocks(images: torch.Tensor, packed: Dict) -> torch.Tensor:
    """`encoder_fused` as 16 wrapper calls of K2 `downsampler` and K1
    `nb1d`: the fused kernel's bit-for-bit reference."""
    x = images.to(torch.bfloat16).contiguous()
    return run_stages(x, packed, ENC_STAGES, BLOCKS)


def pack_decoder(sd: Mapping[str, torch.Tensor], cfg: LaneConfig,
                 fitter: WLSFitter) -> Dict:
    """Folded kernel constants of the decoder, the head and the row-sum
    tail (column coordinate, mask rows, activation): the per-block dicts of
    K1/K3/K4 and the fused kernel's `wbuf`, `vbuf` and offset `table`."""
    packed = {
        "up1": pack_upsampler(sd, f"{_DEC}.layers.0"),
        "nb64": [pack_nb1d(sd, f"{_DEC}.layers.{i}", 1) for i in (1, 2)],
        "up2": pack_upsampler(sd, f"{_DEC}.layers.3"),
        "nb16": [pack_nb1d(sd, f"{_DEC}.layers.{i}", 1) for i in (4, 5)],
        "head": pack_head(sd, f"{_DEC}.output_conv", fitter.sep_xs,
                          zero_rows(cfg), cfg.activation_layer),
    }
    packed.update(flat_constants(packed, DEC_STAGES))
    return packed


def decoder_fused(enc: torch.Tensor, packed: Dict) -> torch.Tensor:
    """enc (B, H/8, W/8, 128) bf16 -> S (B, H, 2C) f32 WLS row sums
    [S0 | S1]."""
    if enc.device.type == "cpu":
        return decoder_plain(enc, packed)
    return decoder_fused_kernel(enc, packed)


def decoder_blocks(enc: torch.Tensor, packed: Dict) -> torch.Tensor:
    """`decoder_fused` as 7 wrapper calls of K3 `upsampler`, K1 `nb1d` and
    K4 `head_rowsums`: the fused kernel's bit-for-bit reference."""
    return run_stages(enc, packed, DEC_STAGES, BLOCKS)
