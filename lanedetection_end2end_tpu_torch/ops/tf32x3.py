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
  plain backward take them), the control of the float32 weight gradients;
- `conv_s2_tf32x3`, `convt_s2_tf32x3`, `wgrad_s2_tf32x3` and their
  single-TF32 twins `conv_s2_tf32`, `convt_s2_tf32`, `wgrad_s2_tf32`: the
  three stride-2 products of K8 / K9 (`csrc/conv_s2_mma.cuh`), with the
  arguments of `ops/lanemaps.py`'s `conv_s2`, `convt_s2` and `wgrad_s2`,
  whose hooks in the plain versions (`downsampler_fwd_plain(...,
  conv=...)` and the others) take them. The transposed convolution is
  computed as the tiles compute it, by its four output parity phases
  (`convt_s2_phases`), interleaved.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from lanedetection_end2end_tpu_torch.ops.lanemaps import conv_s2, wgrad_s2
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


# ----------------------------------------------------------------------
# The stride-2 products of K8 / K9
# ----------------------------------------------------------------------

def _phase_taps(k: int, parity: int):
    """(tap, offset) pairs of one output parity along one axis: output
    index 2i + parity takes tap k_ at small index i + offset. k = 3 (pad
    1): parity 0 tap 1 at i; parity 1 tap 0 at i + 1, then tap 2 at i.
    k = 2: tap `parity` at i."""
    if k == 3:
        return ((1, 0),) if parity == 0 else ((0, 1), (2, 0))
    if k == 2:
        return ((parity, 0),)
    raise ValueError(f"k={k} not in (2, 3)")


def convt_s2_phases(small: torch.Tensor, w: torch.Tensor, k: int):
    """The transposed convolution of `ops/lanemaps.py::convt_s2` in
    float64, by its four output parity phases (py, px): each a dense
    convolution of the small plane with 1, 2, 2 or 4 taps (k = 3; one tap
    each for k = 2), its rows interleaved into the large plane at (2h +
    py, 2w + px); the taps in the kernels' order. small (B, Hs, Ws, cs), w
    (cs, cl, k, k) -> (B, 2Hs, 2Ws, cl) float64."""
    s, wd = small.double(), w.double()
    B, Hs, Ws, _ = s.shape
    edge = F.pad(s, (0, 0, 0, 1, 0, 1))  # a zero row and column past the edge
    out = s.new_zeros(B, 2 * Hs, 2 * Ws, w.shape[1])
    for py in (0, 1):
        for px in (0, 1):
            acc = s.new_zeros(B, Hs, Ws, w.shape[1])
            for ky, dh in _phase_taps(k, py):
                for kx, dw in _phase_taps(k, px):
                    acc = acc + (edge[:, dh:dh + Hs, dw:dw + Ws]
                                 @ wd[:, :, ky, kx])
            out[:, py::2, px::2] = acc
    return out


def _three(fn, a: torch.Tensor, b: torch.Tensor, *args):
    """fn on the split operands, lo * hi + hi * lo + hi * hi, each product
    in float64 -> float32."""
    a_hi, a_lo = (v.double() for v in split_tf32(a.float()))
    b_hi, b_lo = (v.double() for v in split_tf32(b.float()))
    return (fn(a_lo, b_hi, *args) + fn(a_hi, b_lo, *args)
            + fn(a_hi, b_hi, *args)).float()


def _one(fn, a: torch.Tensor, b: torch.Tensor, *args):
    """fn on the TF32-rounded operands, hi * hi -> float32."""
    return fn(round_tf32(a.float()).double(), round_tf32(b.float()).double(),
              *args).float()


def _conv_s2_f64(large, w, k):
    return conv_s2(large.double(), w.double(), k)


def _wgrad_s2_f64(small, large, k):
    return wgrad_s2(small.double(), large.double(), k)


def conv_s2_tf32x3(large: torch.Tensor, w: torch.Tensor, k: int):
    """`conv_s2` as the float32 tiles compute it: three TF32 products."""
    return _three(_conv_s2_f64, large, w, k)


def conv_s2_tf32(large: torch.Tensor, w: torch.Tensor, k: int):
    """`conv_s2` with one TF32 product, hi * hi."""
    return _one(_conv_s2_f64, large, w, k)


def convt_s2_tf32x3(small: torch.Tensor, w: torch.Tensor, k: int):
    """`convt_s2` as the float32 tiles compute it: by parity phases, three
    TF32 products."""
    return _three(convt_s2_phases, small, w, k)


def convt_s2_tf32(small: torch.Tensor, w: torch.Tensor, k: int):
    """`convt_s2` by parity phases with one TF32 product, hi * hi."""
    return _one(convt_s2_phases, small, w, k)


def wgrad_s2_tf32x3(small: torch.Tensor, large: torch.Tensor, k: int):
    """`wgrad_s2` as the float32 tiles compute it: three TF32 products."""
    return _three(_wgrad_s2_f64, small, large, k)


def wgrad_s2_tf32(small: torch.Tensor, large: torch.Tensor, k: int):
    """`wgrad_s2` with one TF32 product, hi * hi."""
    return _one(_wgrad_s2_f64, small, large, k)
