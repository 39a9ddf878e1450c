"""Weight initialization schemes: normal | xavier | kaiming | orthogonal.

Counterpart of `lanedetection_end2end_tpu/models/init.py::init_weights`:
convolution and linear weights get the scheme, biases go to zero,
BatchNorm scales to N(1, 0.02) and their biases to zero; running
statistics stay as they are. The fans are those of the flax layout the
JAX package reads, not torch's: a kernel is drawn in the flax shape, (kh,
kw, in, out) for a convolution or a transposed convolution and (in, out)
for a linear layer, so fan_in = in * kh * kw and fan_out = out * kh * kw,
and is then laid out as the torch weight (`models/port.py`'s conversions).
For a ConvTranspose2d weight (in, out, kh, kw) torch's own
`nn.init.kaiming_normal_` would take fan_in = out * kh * kw instead.

The draws come from a `torch.Generator`, so the values differ from the JAX
package's; the distributions are the same.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn

SCHEMES = ("normal", "xavier", "kaiming", "orthogonal")


def flax_shape(module: nn.Module) -> Tuple[int, ...]:
    """The flax kernel shape of a Conv2d, ConvTranspose2d or Linear
    weight."""
    w = module.weight
    if isinstance(module, nn.ConvTranspose2d):
        i, o, kh, kw = w.shape
        return (kh, kw, i, o)
    if isinstance(module, nn.Conv2d):
        o, i, kh, kw = w.shape
        return (kh, kw, i, o)
    if isinstance(module, nn.Linear):
        o, i = w.shape
        return (i, o)
    raise TypeError(f"no flax kernel for {type(module).__name__}")


def fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """(fan_in, fan_out) of a flax kernel shape: conv (kh, kw, in, out) or
    dense (in, out)."""
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def kernel_fans(model: nn.Module) -> Dict[str, Tuple[int, int]]:
    """{torch weight name: (fan_in, fan_out)} of every kernel that
    `init_weights` draws."""
    return {f"{name}.weight": fans(flax_shape(m))
            for name, m in model.named_modules()
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))}


def _orthogonal(shape, generator) -> torch.Tensor:
    """flax's orthogonal initializer: the kernel flattened to (prod of all
    but the last dimension, last), with orthonormal columns or rows,
    whichever are fewer; the signs follow R's diagonal."""
    rows, cols = math.prod(shape[:-1]), shape[-1]
    a = torch.randn(max(rows, cols), min(rows, cols), generator=generator,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return q.reshape(shape).float()


def draw_kernel(shape, scheme: str, generator) -> torch.Tensor:
    """A kernel of flax shape `shape` drawn by `scheme`."""
    if scheme == "orthogonal":
        return _orthogonal(shape, generator)
    z = torch.randn(shape, generator=generator)
    fan_in, fan_out = fans(shape)
    if scheme == "normal":
        return 0.02 * z
    if scheme == "xavier":
        return 0.02 * math.sqrt(2.0 / (fan_in + fan_out)) * z
    if scheme == "kaiming":
        return math.sqrt(2.0 / fan_in) * z
    raise NotImplementedError(
        f"initialization method [{scheme}] is not implemented")


def _to_torch(module: nn.Module, k: torch.Tensor) -> torch.Tensor:
    """A flax-layout kernel as `module`'s weight (models/port.py)."""
    if isinstance(module, nn.ConvTranspose2d):
        return k.flip(0, 1).permute(2, 3, 0, 1)
    if isinstance(module, nn.Conv2d):
        return k.permute(3, 2, 0, 1)
    # (a linear layer after a flatten orders its inputs (h, w, c) in flax
    # and (c, h, w) in torch: a permutation of the rows of an iid or
    # orthogonal draw, which leaves its distribution as it is)
    return k.T


@torch.no_grad()
def init_weights(model: nn.Module, scheme: str,
                 generator: torch.Generator) -> nn.Module:
    """Re-draw `model`'s parameters in place by `scheme`; returns it."""
    if scheme not in SCHEMES:
        raise NotImplementedError(
            f"initialization method [{scheme}] is not implemented")
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            k = draw_kernel(flax_shape(m), scheme, generator)
            m.weight.copy_(_to_torch(m, k))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            z = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(1.0 + 0.02 * z)
            m.bias.zero_()
    return model
