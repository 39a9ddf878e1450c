"""Line and horizon heads on the encoder features.

Counterpart of `lanedetection_end2end_tpu/models/heads.py` with the
reference torch names (`conv{i}`, `conv{i}_bn`, `fully_connected1`,
`fully_connected_line{k}`, `fully_connected_horizon`). The line head's
last layer depends on the variant: 'bp', one Linear to 4 lane-presence
logits (B, 4); 'bev', four Linear layers `fully_connected_line1..4` of 3
line-type logits each, stacked to (B, 3, 4). Four conv+BN+relu
stages (128, 128, 64, 64; BN eps 1e-5, the torch default; in train mode
the batch statistics and running-stat rule of `models/erfnet.py::
BatchNorm2d`), then a 2x2
maxpool + two Linear layers for the line head, or an average over the full
width + one Linear layer for the horizon head. NCHW: the flatten before a
Linear layer is channel-major, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from lanedetection_end2end_tpu_torch.models.erfnet import BatchNorm2d

BN_EPS = 1e-5


class Classification(nn.Module):
    def __init__(self, class_type: str, resize: int = 256,
                 variant: str = "bp"):
        super().__init__()
        if class_type not in ("line", "horizon"):
            raise ValueError(class_type)
        if variant not in ("bp", "bev"):
            raise ValueError(variant)
        self.class_type = class_type
        self.variant = variant
        chans = (128, 128, 128, 64, 64)
        for i in range(4):
            k = 1 if i == 0 else 3
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(chans[i], chans[i + 1], k, padding=k // 2))
            setattr(self, f"conv{i + 1}_bn",
                    BatchNorm2d(chans[i + 1], eps=BN_EPS))
        rows, cols = resize // 8, 2 * resize // 8  # encoder feature plane
        if class_type == "line":
            self.fully_connected1 = nn.Linear(64 * (rows // 2) * (cols // 2),
                                              128)
            if variant == "bev":
                for k in range(1, 5):
                    setattr(self, f"fully_connected_line{k}",
                            nn.Linear(128, 3))
            else:
                self.fully_connected_line1 = nn.Linear(128, 4)
        else:
            self.fully_connected_horizon = nn.Linear(64 * rows, resize)

    def forward(self, x):
        """x: (B, 128, rows, cols) -> line logits, (B, 4) 'bp' or (B, 3, 4)
        'bev', or horizon logits (B, resize)."""
        for i in range(1, 5):
            x = getattr(self, f"conv{i}")(x)
            x = F.relu(getattr(self, f"conv{i}_bn")(x))
        if self.class_type == "line":
            x = F.max_pool2d(x, 2, 2).flatten(1)
            x = F.relu(self.fully_connected1(x))
            if self.variant == "bev":
                return torch.stack(
                    [getattr(self, f"fully_connected_line{k}")(x)
                     for k in range(1, 5)], dim=2)
            return self.fully_connected_line1(x)
        x = x.mean(dim=3).flatten(1)  # AvgPool2d((1, cols)), then flatten
        return self.fully_connected_horizon(x)
