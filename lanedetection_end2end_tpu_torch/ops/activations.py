"""Weight-map activations applied to the decoder output before the LSQ fit:
square | sigmoid | relu | softplus | abs | none.

Counterpart of `lanedetection_end2end_tpu/ops/activations.py`. `ACTIVATIONS`
also fixes the integer code the head kernel (`csrc/head_rowsums.cu`) takes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "square": lambda x: x * x,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "softplus": F.softplus,
    "abs": torch.abs,
    "none": lambda x: x,
}
ACTIVATIONS = tuple(_ACTIVATIONS)


def activation_fn(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise NotImplementedError(
            f"Activation type: {name} is not implemented") from None


def activation_code(name: str) -> int:
    """Index of `name` in ACTIVATIONS, as the head kernel reads it."""
    activation_fn(name)
    return ACTIVATIONS.index(name)
