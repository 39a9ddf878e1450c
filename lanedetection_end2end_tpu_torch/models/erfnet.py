"""ERFNet backbone as eval-mode PyTorch modules (NCHW, reference names).

Counterpart of `lanedetection_end2end_tpu/models/erfnet.py`. The modules
hold the weights under the reference torch names (`encoder.initial_block`,
`encoder.layers.{i}`, `decoder.layers.{i}`, `decoder.output_conv`), so a
reference checkpoint loads directly. The forward is the f32 reference of
the serving engine: eval mode only (running BatchNorm statistics, no
dropout).

- DownsamplerBlock: 3x3/s2 conv (out-in channels) || 2x2 maxpool, concat,
  BN(eps=1e-3), relu
- NonBottleneck1D: 3x1, 1x3, dilated 3x1, dilated 1x3 convs, two BNs,
  residual relu
- UpsamplerBlock: ConvTranspose 3x3/s2/p1/op1, BN, relu
- Encoder: 3->16 -> 64 (5x NB1D) -> 128 (2x NB1D dilations 2/4/8/16), and
  the 1x1 predict head the e2e phase never reads
- Decoder: Up(128->64), 2x NB1D, Up(64->16), 2x NB1D, ConvT 2x2/s2 head
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3

ENC_DILATIONS = [1] * 5 + [2, 4, 8, 16] * 2  # NB1D blocks of the encoder


class DownsamplerBlock(nn.Module):
    def __init__(self, ninput: int, noutput: int):
        super().__init__()
        self.conv = nn.Conv2d(ninput, noutput - ninput, 3, stride=2,
                              padding=1, bias=True)
        self.bn = nn.BatchNorm2d(noutput, eps=BN_EPS)

    def forward(self, x):
        y = torch.cat([self.conv(x), F.max_pool2d(x, 2, 2)], dim=1)
        return F.relu(self.bn(y))


class NonBottleneck1D(nn.Module):
    def __init__(self, chann: int, dilated: int):
        super().__init__()
        d = dilated
        self.conv3x1_1 = nn.Conv2d(chann, chann, (3, 1), padding=(1, 0))
        self.conv1x3_1 = nn.Conv2d(chann, chann, (1, 3), padding=(0, 1))
        self.bn1 = nn.BatchNorm2d(chann, eps=BN_EPS)
        self.conv3x1_2 = nn.Conv2d(chann, chann, (3, 1), padding=(d, 0),
                                   dilation=(d, 1))
        self.conv1x3_2 = nn.Conv2d(chann, chann, (1, 3), padding=(0, d),
                                   dilation=(1, d))
        self.bn2 = nn.BatchNorm2d(chann, eps=BN_EPS)

    def forward(self, x):
        y = F.relu(self.conv3x1_1(x))
        y = F.relu(self.bn1(self.conv1x3_1(y)))
        y = F.relu(self.conv3x1_2(y))
        y = self.bn2(self.conv1x3_2(y))
        return F.relu(y + x)


class Encoder(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.initial_block = DownsamplerBlock(3, 16)
        layers = [DownsamplerBlock(16, 64)]
        layers += [NonBottleneck1D(64, d) for d in ENC_DILATIONS[:5]]
        layers.append(DownsamplerBlock(64, 128))
        layers += [NonBottleneck1D(128, d) for d in ENC_DILATIONS[5:]]
        self.layers = nn.ModuleList(layers)
        self.output_conv = nn.Conv2d(128, num_classes, 1, bias=True)

    def forward(self, x):
        x = self.initial_block(x)
        for layer in self.layers:
            x = layer(x)
        return x


class UpsamplerBlock(nn.Module):
    def __init__(self, ninput: int, noutput: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(ninput, noutput, 3, stride=2,
                                       padding=1, output_padding=1, bias=True)
        self.bn = nn.BatchNorm2d(noutput, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Decoder(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.layers = nn.ModuleList([
            UpsamplerBlock(128, 64), NonBottleneck1D(64, 1),
            NonBottleneck1D(64, 1), UpsamplerBlock(64, 16),
            NonBottleneck1D(16, 1), NonBottleneck1D(16, 1)])
        self.output_conv = nn.ConvTranspose2d(16, num_classes, 2, stride=2,
                                              padding=0, output_padding=0,
                                              bias=True)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return self.output_conv(x)


class ERFNet(nn.Module):
    """Encoder + decoder; forward returns (encoder_features, seg_logits),
    both NCHW."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.encoder = Encoder(num_classes)
        self.decoder = Decoder(num_classes)

    def forward(self, x):
        enc = self.encoder(x)
        return enc, self.decoder(enc)
