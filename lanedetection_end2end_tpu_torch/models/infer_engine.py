"""Fused inference engine: the serving-path forward pass of the port.

Counterpart of `lanedetection_end2end_tpu/models/infer_engine.py`
(`FusedLaneNetEngine`): the same math as the e2e eval forward of `LaneNet`,
on the same weights, with BatchNorm folded into the kernels' constants once
per checkpoint. The heads run as plain PyTorch in bf16 on the bf16 encoder
features. Two paths, JAX's two modes; each call takes the one its fitter
needs:

- "full", for a separable fitter: the backbone as two hand-written
  cooperative launches (`models/fused_graph.py`: the whole encoder, then
  the whole decoder ending in the WLS row sums), and the separable fit
  from them;
- "blocks", for a non-separable fitter (a general homography assigned to
  `engine.fitter`, say): the 17 NB1D blocks as four `nb1d_chain` launches
  (5 x 64, 8 x 128, 2 x 64, 2 x 16 channels), the stride-2 blocks and the
  output head as bf16 PyTorch modules between them (cuDNN: in JAX they
  are XLA convolutions, no Pallas kernel), then f32 activation, row mask
  and `self.fitter(masked)`, whose moments run on K12 `wls_moments`, or
  on its plain version where the fitter has `use_pallas=False` (the
  engine's own fitter takes the config's `use_pallas_wls`, as JAX's
  engine takes its LaneNet's fitter).
  Activations stay NHWC in memory (channels_last around the cuDNN calls),
  so the chain kernel's NHWC planes are views.

Usage:
    engine = FusedLaneNetEngine(cfg)          # on the card; device="cpu"
    packed = engine.prepare(state_dict)       # once per checkpoint
    beta, line, horizon = engine(packed, images)
    engine.fitter = WLSFitter(M_general, ...) # later calls: blocks path
    fn = engine.sharded_call(dp.group)        # one rank of N: its rows
    beta, line, horizon = fn(packed, images)  # the global batch's

`state_dict` carries the reference torch names (`LaneNet(cfg).state_dict()`
or `models/port.py::state_dict_from_variables`). Both profiles serve: the
'bev' fitter (normalized homography) is separable too, so it takes the
full path, with the BEV line head's (B, 3, 4) logits. On a CPU device
every kernel wrapper takes its plain version.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch
import torch.nn as nn

from lanedetection_end2end_tpu_torch.config import LaneConfig
from lanedetection_end2end_tpu_torch.device import resolve_device
from lanedetection_end2end_tpu_torch.models.erfnet import (
    ENC_DILATIONS, DownsamplerBlock, UpsamplerBlock)
from lanedetection_end2end_tpu_torch.models.fused_graph import (
    decoder_fused, encoder_fused, pack_decoder, pack_encoder)
from lanedetection_end2end_tpu_torch.models.heads import Classification
from lanedetection_end2end_tpu_torch.models.lanenet import (
    make_fitter, row_mask)
from lanedetection_end2end_tpu_torch.ops.activations import activation_fn
from lanedetection_end2end_tpu_torch.ops.nb1d import (
    nb1d_chain, pack_chain, pack_nb1d)
from lanedetection_end2end_tpu_torch.parallel.collectives import gather_rows
from lanedetection_end2end_tpu_torch.parallel.mesh import local_rows
from lanedetection_end2end_tpu_torch.utils.profiling import span

BF16 = torch.bfloat16
_HEADS = (("line_classification", "line"), ("horizon_estimation", "horizon"))
_ENC, _DEC = "net.encoder", "net.decoder"
# blocks mode: (chain, [(layer prefix, dilation)]), in ERFNet's order
_CHAINS = {
    "enc_nb64": [(f"{_ENC}.layers.{1 + i}", d)
                 for i, d in enumerate(ENC_DILATIONS[:5])],
    "enc_nb128": [(f"{_ENC}.layers.{7 + i}", d)
                  for i, d in enumerate(ENC_DILATIONS[5:])],
    "dec_nb64": [(f"{_DEC}.layers.{i}", 1) for i in (1, 2)],
    "dec_nb16": [(f"{_DEC}.layers.{i}", 1) for i in (4, 5)],
}
# blocks mode: the stride-2 blocks and the output head as modules
_MODULES = {
    "initial": (f"{_ENC}.initial_block", lambda C: DownsamplerBlock(3, 16)),
    "down1": (f"{_ENC}.layers.0", lambda C: DownsamplerBlock(16, 64)),
    "down2": (f"{_ENC}.layers.6", lambda C: DownsamplerBlock(64, 128)),
    "up1": (f"{_DEC}.layers.0", lambda C: UpsamplerBlock(128, 64)),
    "up2": (f"{_DEC}.layers.3", lambda C: UpsamplerBlock(64, 16)),
    "output_conv": (f"{_DEC}.output_conv",
                    lambda C: nn.ConvTranspose2d(16, C, 2, stride=2)),
}


def _load(module: nn.Module, sd: Mapping[str, torch.Tensor], prefix: str):
    n = len(prefix) + 1
    module.load_state_dict({k[n:]: v for k, v in sd.items()
                            if k.startswith(prefix + ".")})
    return module


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW view of a channels_last tensor -> contiguous NHWC (a view)."""
    return t.permute(0, 2, 3, 1).contiguous()


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> its NCHW view (channels_last)."""
    return t.permute(0, 3, 1, 2)


class FusedLaneNetEngine:
    def __init__(self, cfg: LaneConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fitter = make_fitter(cfg, self.device)
        self._mask = row_mask(cfg, self.device)
        self._act = activation_fn(cfg.activation_layer)

    def prepare(self, state_dict: Mapping[str, torch.Tensor]) -> Dict:
        """Fold BN and lay out the kernel constants on the device (once per
        checkpoint): the blocks path's chains, its stride-2 blocks and
        output head as bf16 eval modules (BatchNorm in f32), and, for a
        separable fitter, the full path's constants (the fused encoder's and
        decoder's flat buffers beside the per-block dicts; the decoder
        bakes in the fitter's row-sum coordinates); the heads as bf16 eval
        modules."""
        sd = {k: v.detach().to(self.device) for k, v in state_dict.items()}
        packed = {name: pack_chain([pack_nb1d(sd, prefix, d)
                                    for prefix, d in blocks])
                  for name, blocks in _CHAINS.items()}
        for name, (prefix, make) in _MODULES.items():
            packed[name] = self._bf16(
                _load(make(self.cfg.out_channels), sd, prefix))
        if self.fitter.separable:
            packed.update(enc=pack_encoder(sd),
                          dec=pack_decoder(sd, self.cfg, self.fitter))
        if self.cfg.clas:
            for key, kind in _HEADS:
                head = _load(Classification(kind, self.cfg.resize,
                                            self.cfg.profile), sd, key)
                packed[kind] = head.to(self.device, BF16).eval()
        return packed

    def _bf16(self, module: nn.Module) -> nn.Module:
        """bf16 convolution weights in channels_last, BatchNorm in f32."""
        module = module.to(self.device, BF16).eval()
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.float()
        return module.to(memory_format=torch.channels_last)

    def __call__(self, packed: Dict, images: torch.Tensor) -> tuple:
        """images (B, H, W, 3) -> (beta (B, C, order+1) f32, line logits
        f32 ((B, 4) 'bp', (B, 3, 4) 'bev') | None, horizon logits
        (B, resize) f32 | None): the full path for a separable fitter,
        else blocks. C is the config's `out_channels`, any count the head
        kernels take (1 to 8)."""
        return self._run(packed, images, blocks=not self.fitter.separable)

    def sharded_call(self, group) -> Callable:
        """The data-parallel serving call over the ranks of `group` (JAX's
        `sharded_call(mesh)`): fn(packed, images) takes the global images
        (B, H, W, 3) on every rank, runs this engine's kernels on the
        rank's contiguous rows (`parallel/mesh.py::local_rows`) and
        returns the global (beta, line, horizon), gathered in row order on
        every rank. B must divide over the ranks."""
        def fn(packed: Dict, images: torch.Tensor) -> tuple:
            out = self(packed, local_rows(images, group))
            return tuple(None if t is None else gather_rows(t, group)
                         for t in out)
        return fn

    @torch.no_grad()
    def _run(self, packed: Dict, images: torch.Tensor, blocks: bool
             ) -> tuple:
        """`__call__` on the path named by `blocks`; blocks=True with a
        separable fitter is JAX's `mode="blocks"`, which the tests and
        `chip_smoke.py` hold against the full path."""
        images = images.to(self.device)
        with span("serve.backbone", self.device):
            if not blocks:
                enc = encoder_fused(images, packed["enc"])
                S = decoder_fused(enc, packed["dec"])          # (B, H, 2C)
                C = self.cfg.out_channels
                beta = self.fitter.beta_from_rowsums(
                    S[..., :C].transpose(1, 2), S[..., C:].transpose(1, 2))
            else:
                enc, beta = self._call_blocks(packed, images)
        line = horizon = None
        if self.cfg.clas:
            with span("serve.heads", self.device):
                e = _nchw(enc)  # NCHW view of the NHWC features
                line = packed["line"](e).float()
                horizon = packed["horizon"](e).float()
        return beta, line, horizon

    def _call_blocks(self, packed: Dict, images: torch.Tensor) -> tuple:
        """-> (encoder features (B, H/8, W/8, 128) bf16, beta)."""
        x = _nchw(images.to(BF16).contiguous())
        x = packed["down1"](packed["initial"](x))
        t = nb1d_chain(_nhwc(x), packed["enc_nb64"])
        x = packed["down2"](_nchw(t))
        enc = nb1d_chain(_nhwc(x), packed["enc_nb128"])
        y = packed["up1"](_nchw(enc))
        t = nb1d_chain(_nhwc(y), packed["dec_nb64"])
        y = packed["up2"](_nchw(t))
        t = nb1d_chain(_nhwc(y), packed["dec_nb16"])
        dec = _nhwc(packed["output_conv"](_nchw(t))).float()   # (B,H,W,C)
        masked = self._act(dec) * self._mask
        return enc, self.fitter(masked)
