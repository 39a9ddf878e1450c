"""Homography-offset predictor head of the learned-homography option.

Counterpart of `lanedetection_end2end_tpu/models/dlt.py::HomographyHead`:
a small conv + BatchNorm stack over the encoder features that the line
and horizon heads share, pooled to three trapezoid offsets squashed by
tanh / 16 (`geometry/dlt.py::dlt_homography` turns them into per-sample
matrices). The last layer, `fc_offsets`, starts at zero, so a freshly
built head reproduces the fixed calibrated homography; `init_weights`
re-draws its kernel like every other (as the JAX package's tree walk
does), so a Trainer run starts off that matrix in both packages.

- `conv1` 1x1 128 -> 128, then `conv2..4` 3x3 padding 1 (128, 64, 64),
  each followed by its BatchNorm `conv{i}_bn` (eps 1e-5; train mode as
  `models/erfnet.py::BatchNorm2d`) and relu, a 2x2 max-pool after the
  third;
- global average pool, `fc1` Linear 64 -> 128 + relu, `fc_offsets`
  Linear 128 -> 3, tanh taken in float32, / 16.

The submodules carry the flax names, so the weight carrier maps them as
`homography_head.<flax name>.*` (`models/port.py`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from lanedetection_end2end_tpu_torch.models.erfnet import BatchNorm2d

BN_EPS = 1e-5
CHANNELS = (128, 128, 128, 64, 64)  # input, then conv1..conv4


class HomographyHead(nn.Module):
    """Encoder features (B, 128, H/8, W/8), NCHW -> (B, 3) normalized
    trapezoid offsets in (-1/16, 1/16): (dx_left, dx_right, dy_top)."""

    def __init__(self):
        super().__init__()
        for i in range(4):
            k = 1 if i == 0 else 3
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(CHANNELS[i], CHANNELS[i + 1], k,
                              padding=k // 2))
            setattr(self, f"conv{i + 1}_bn",
                    BatchNorm2d(CHANNELS[i + 1], eps=BN_EPS))
        self.fc1 = nn.Linear(CHANNELS[-1], 128)
        self.fc_offsets = nn.Linear(128, 3)
        nn.init.zeros_(self.fc_offsets.weight)
        nn.init.zeros_(self.fc_offsets.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = getattr(self, f"conv{i}")(x)
            x = F.relu(getattr(self, f"conv{i}_bn")(x))
            if i == 3:
                x = F.max_pool2d(x, 2, 2)
        x = x.mean(dim=(2, 3))                       # (B, 64)
        x = self.fc_offsets(F.relu(self.fc1(x)))
        return torch.tanh(x.float()) / 16.0
