"""Train state: what one step carries from call to call.

Counterpart of `lanedetection_end2end_tpu/train/state.py`. The JAX state
is a pytree of parameters, BatchNorm statistics and optimizer state that a
pure step maps to a new one; here the model and the optimizer hold those
and a step updates them in place.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module            # parameters and BatchNorm statistics
    optimizer: torch.optim.Optimizer  # moments and the learning rate
    step: int = 0                     # optimizer steps taken
