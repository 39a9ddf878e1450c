"""ERFNet backbone as PyTorch modules (NCHW, reference names).

Counterpart of `lanedetection_end2end_tpu/models/erfnet.py`. The modules
hold the weights under the reference torch names (`encoder.initial_block`,
`encoder.layers.{i}`, `decoder.layers.{i}`, `decoder.output_conv`), so a
reference checkpoint loads directly. The forward is the f32 reference of
the serving engine (eval mode) and of the packed training backbone
(`ops/packed_graph.py`, which reads these modules' parameters). In train
mode (`module.train()`), BatchNorm normalizes with the batch statistics and
updates the running ones by the JAX package's rule (`BatchNorm2d` below),
and the encoder's NB1D blocks apply Dropout2d (0.03 in the 64-channel
stage, 0.3 in the 128-channel stage, none in the decoder) when the forward
is given a `torch.Generator`.

- DownsamplerBlock: 3x3/s2 conv (out-in channels) || 2x2 maxpool, concat,
  BN(eps=1e-3), relu
- NonBottleneck1D: 3x1, 1x3, dilated 3x1, dilated 1x3 convs, two BNs,
  residual relu
- UpsamplerBlock: ConvTranspose 3x3/s2/p1/op1, BN, relu
- Encoder: 3->16 -> 64 (5x NB1D) -> 128 (2x NB1D dilations 2/4/8/16), and
  the 1x1 predict head the e2e phase never reads
- Decoder: Up(128->64), 2x NB1D, Up(64->16), 2x NB1D, ConvT 2x2/s2 head
  (`output_conv`); with `pretrained`, also the pretraining head
  `output_conv2` of num_classes + 1 channels (the background), and
  `use_main_head` picks which one the forward returns (the seg phase of
  the staged schedule reads the aux head, the e2e phase the main one)
- `do_segmentation`: a second decoder, `decoder_seg`, with num_classes + 1
  channels (the reference's declared but dormant segmentation branch);
  off by default, and `LaneNet` never turns it on, as in the JAX package
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lanedetection_end2end_tpu_torch.ops.packed_graph import dropout2d

BN_EPS = 1e-3
DROPOUT_1, DROPOUT_2 = 0.03, 0.3  # encoder 64- and 128-channel stages

ENC_DILATIONS = [1] * 5 + [2, 4, 8, 16] * 2  # NB1D blocks of the encoder


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d with the JAX package's (flax) train-mode rule: batch
    statistics in f32 with the *biased* variance mean(x^2) - mean(x)^2,
    which is also what the running variance accumulates (momentum 0.1 on
    the new value); `torch.nn.BatchNorm2d` would store the unbiased one.
    Computes in f32 and returns the input's dtype."""

    def forward(self, x):
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = self.weight.float() * torch.rsqrt(var + self.eps)
        add = self.bias.float() - mean * mul
        y = xf * mul[None, :, None, None] + add[None, :, None, None]
        return y.to(x.dtype)


class DownsamplerBlock(nn.Module):
    def __init__(self, ninput: int, noutput: int):
        super().__init__()
        self.conv = nn.Conv2d(ninput, noutput - ninput, 3, stride=2,
                              padding=1, bias=True)
        self.bn = BatchNorm2d(noutput, eps=BN_EPS)

    def forward(self, x):
        y = torch.cat([self.conv(x), F.max_pool2d(x, 2, 2)], dim=1)
        return F.relu(self.bn(y))


class NonBottleneck1D(nn.Module):
    def __init__(self, chann: int, dilated: int, dropprob: float = 0.0):
        super().__init__()
        d = dilated
        self.dropprob = dropprob
        self.conv3x1_1 = nn.Conv2d(chann, chann, (3, 1), padding=(1, 0))
        self.conv1x3_1 = nn.Conv2d(chann, chann, (1, 3), padding=(0, 1))
        self.bn1 = BatchNorm2d(chann, eps=BN_EPS)
        self.conv3x1_2 = nn.Conv2d(chann, chann, (3, 1), padding=(d, 0),
                                   dilation=(d, 1))
        self.conv1x3_2 = nn.Conv2d(chann, chann, (1, 3), padding=(0, d),
                                   dilation=(1, d))
        self.bn2 = BatchNorm2d(chann, eps=BN_EPS)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y = F.relu(self.conv3x1_1(x))
        y = F.relu(self.bn1(self.conv1x3_1(y)))
        y = F.relu(self.conv3x1_2(y))
        y = self.bn2(self.conv1x3_2(y))
        y = dropout2d(y, self.dropprob, generator, self.training,
                      channel_dim=1)
        return F.relu(y + x)


class Encoder(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.initial_block = DownsamplerBlock(3, 16)
        layers = [DownsamplerBlock(16, 64)]
        layers += [NonBottleneck1D(64, d, DROPOUT_1)
                   for d in ENC_DILATIONS[:5]]
        layers.append(DownsamplerBlock(64, 128))
        layers += [NonBottleneck1D(128, d, DROPOUT_2)
                   for d in ENC_DILATIONS[5:]]
        self.layers = nn.ModuleList(layers)
        self.output_conv = nn.Conv2d(128, num_classes, 1, bias=True)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.initial_block(x)
        for layer in self.layers:
            if isinstance(layer, NonBottleneck1D):
                x = layer(x, generator)
            else:
                x = layer(x)
        return x


class UpsamplerBlock(nn.Module):
    def __init__(self, ninput: int, noutput: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(ninput, noutput, 3, stride=2,
                                       padding=1, output_padding=1, bias=True)
        self.bn = BatchNorm2d(noutput, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Decoder(nn.Module):
    def __init__(self, num_classes: int, pretrained: bool = False):
        super().__init__()
        self.layers = nn.ModuleList([
            UpsamplerBlock(128, 64), NonBottleneck1D(64, 1),
            NonBottleneck1D(64, 1), UpsamplerBlock(64, 16),
            NonBottleneck1D(16, 1), NonBottleneck1D(16, 1)])
        self.output_conv = nn.ConvTranspose2d(16, num_classes, 2, stride=2,
                                              padding=0, output_padding=0,
                                              bias=True)
        if pretrained:
            self.output_conv2 = nn.ConvTranspose2d(
                16, num_classes + 1, 2, stride=2, padding=0,
                output_padding=0, bias=True)

    def forward(self, x, use_main_head: bool = True):
        """The blocks, then `output_conv`, or the pretraining head
        `output_conv2` where there is one and `use_main_head` is False."""
        for layer in self.layers:
            x = layer(x)
        if use_main_head or not hasattr(self, "output_conv2"):
            return self.output_conv(x)
        return self.output_conv2(x)


class ERFNet(nn.Module):
    """Encoder + decoder; forward returns (encoder_features, seg_logits,
    seg), all NCHW: the logits from the main head or, with `pretrained`
    and `use_main_head=False`, from the pretraining head; `seg` the
    `decoder_seg` logits with `do_segmentation`, else the encoder
    features again (the reference's default)."""

    def __init__(self, num_classes: int, pretrained: bool = False,
                 do_segmentation: bool = False):
        super().__init__()
        self.encoder = Encoder(num_classes)
        self.decoder = Decoder(num_classes, pretrained)
        if do_segmentation:
            self.decoder_seg = Decoder(num_classes + 1)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                use_main_head: bool = True):
        enc = self.encoder(x, generator)
        dec = self.decoder(enc, use_main_head)
        if hasattr(self, "decoder_seg"):
            return enc, dec, self.decoder_seg(enc)
        return enc, dec, enc
