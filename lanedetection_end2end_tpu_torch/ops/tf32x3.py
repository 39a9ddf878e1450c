"""The 3xTF32 split of the float32 training convolutions, in plain PyTorch.

The float32 tiles of `csrc/conv3tap_f32.cuh` (K6 / K7 and K11 in float32)
multiply on the tensor cores in TF32, which keeps 10 of float32's 23
mantissa bits. Each f32 operand a is split into two TF32 values,

    hi = tf32(a),  lo = tf32(a - hi)          (cvt.rna.tf32.f32, both)

and a product a * b is taken as lo_a * hi_b + hi_a * lo_b + hi_a * hi_b,
three TF32 products with f32 accumulation: only lo_a * lo_b (about 2^-22
of the product) and the accumulation's own rounding are lost, so the sum
keeps about float32's accuracy. One TF32 product alone (hi_a * hi_b) is
off by up to about 2^-10 of each product.

This module states that arithmetic where there is no GPU:

- `round_tf32(x)`: round float32 to TF32 (10 mantissa bits), to nearest
  with ties away from zero, on the float32 bits, as `cvt.rna.tf32.f32`;
- `split_tf32(x) -> (hi, lo)`;
- `conv3_tf32x3` / `conv3_tf32`: the 3-tap convolution of `ops/nb1d.py`'s
  `_conv3` (same arguments) from the split operands, three products or
  one, each product exact and the sums in float64, rounded to float32 at
  the end. They plug into the half blocks' plain versions
  (`ops/nb_block.py::half_fwd_plain(..., conv=...)`), which is how the
  tests hold the split against the JAX package and how `chip_smoke.py`
  builds its single-TF32 control;
- `wgrad3_tf32x3` / `wgrad3_tf32`: the same for the weight gradient
  `ops/nb_block.py::_wgrad3` (`half_bwd_plain(..., wgrad=...)` and K11's
  plain backward take them), the control of the float32 weight gradients.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from lanedetection_end2end_tpu_torch.ops.nb_block import _wgrad3

_HALF_ULP = 0x1000  # half of the 13 mantissa bits TF32 drops
_KEEP = -0x2000     # ~0x1FFF as an int32: clears those 13 bits


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 holding the nearest TF32 value (10 mantissa
    bits), ties away from zero. Adding half an ulp to the magnitude bits
    and clearing the 13 low bits rounds the magnitude, whatever the sign;
    +-inf and TF32 values are left as they are."""
    if x.dtype != torch.float32:
        raise TypeError(f"round_tf32: expected float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + _HALF_ULP) & _KEEP).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo), both TF32 values, hi = tf32(x), lo = tf32(x - hi);
    x - hi is exact in float32, so hi + lo is within about 2^-22 |x|."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def _conv3_f64(t: torch.Tensor, w: torch.Tensor, axis: int, d: int):
    """`_conv3` in float64: (B, H, W, ci) and (3, ci, co) -> (B, H, W, co),
    taps at -d, 0, +d along H (axis 0) or W (axis 1), zero padding."""
    k = w.double().permute(2, 1, 0)  # (co, ci, 3)
    if axis == 0:
        weight, pad, dil = k.unsqueeze(-1), (d, 0), (d, 1)
    else:
        weight, pad, dil = k.unsqueeze(2), (0, d), (1, d)
    y = F.conv2d(t.double().permute(0, 3, 1, 2), weight, padding=pad,
                 dilation=dil)
    return y.permute(0, 2, 3, 1)


def conv3_tf32x3(t: torch.Tensor, w: torch.Tensor, axis: int, d: int):
    """The 3-tap convolution as the float32 tiles compute it: operands
    split, lo * hi + hi * lo + hi * hi, -> float32."""
    t_hi, t_lo = split_tf32(t.float())
    w_hi, w_lo = split_tf32(w.float())
    y = (_conv3_f64(t_lo, w_hi, axis, d) + _conv3_f64(t_hi, w_lo, axis, d)
         + _conv3_f64(t_hi, w_hi, axis, d))
    return y.float()


def conv3_tf32(t: torch.Tensor, w: torch.Tensor, axis: int, d: int):
    """The same with one TF32 product, hi * hi: what a TF32 tile without
    the split computes -> float32."""
    return _conv3_f64(round_tf32(t.float()), round_tf32(w.float()), axis,
                      d).float()


def wgrad3_tf32x3(a: torch.Tensor, dy: torch.Tensor, axis: int, d: int):
    """The weight gradient dk[t] = shift_t(a)^T @ dy as the float32 tiles
    compute it: operands split, lo * hi + hi * lo + hi * hi, -> float32."""
    a_hi, a_lo = (v.double() for v in split_tf32(a.float()))
    d_hi, d_lo = (v.double() for v in split_tf32(dy.float()))
    return (_wgrad3(a_lo, d_hi, axis, d) + _wgrad3(a_hi, d_lo, axis, d)
            + _wgrad3(a_hi, d_hi, axis, d)).float()


def wgrad3_tf32(a: torch.Tensor, dy: torch.Tensor, axis: int, d: int):
    """The same with one TF32 product, hi * hi -> float32."""
    return _wgrad3(round_tf32(a.float()).double(),
                   round_tf32(dy.float()).double(), axis, d).float()
