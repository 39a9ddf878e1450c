"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
card and no request they raise: the port never continues on the CPU
silently.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device, or RuntimeError without one;
    anything else -> `torch.device(device)`."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
