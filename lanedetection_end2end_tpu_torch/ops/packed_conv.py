"""K11 and channel_sums: the single convolutions and the batch moments of
the unfused training path.

Counterpart of `lanedetection_end2end_tpu/ops/pallas_packed_conv.py`, on
NHWC planes (B, H, W, C) in bf16 or float32, C in {16, 64, 128} on the
card. Taps are (3, ci, co) f32 with tap 0 on the row or column at -d, as
in `ops/nb_block.py`; `axis` is "h" (a 3x1 convolution over rows) or "w"
(a 1x3 convolution over columns), and `d` counts pixels on both axes (the
JAX package's "w" axis takes d*C lanes of its packed plane instead).

    packed_conv_act(x, k, b, axis, d, act) -> y in x's dtype
        y = [relu](conv(x, k) + b)          (JAX `packed_conv_act`)
      backward: dz = dy * (y > 0) with relu, else dy;
                dx = convT(dz, k) in x's dtype, dk = sum shift(x)^T dz and
                db = sum dz, both f32 (JAX `_bwd_act_kernel`)
    packed_conv(x, k, axis, d) -> y f32, no bias (JAX `packed_conv`)
      backward: dy rounded to x's dtype; dx = convT(dy, k) in x's dtype,
                dk f32 (JAX `_run_apply` on the transposed taps,
                `_run_wgrad`)
    channel_sums(x) -> (2, C) f32 [sum; sum of squares] per channel

Operands are read in x's dtype (the taps rounded to it), sums accumulate
in f32, and the relu mask is taken of the rounded output, where the TPU
kernels do the same. The TPU's (128, 128) block-diagonal `kexp` and `sel`
matrices are lane-packing devices and are not ported: the taps are
(3, C, C) and the moments (2, C).

Each function is a `torch.autograd.Function` with plain versions beside
it (`*_fwd_plain`, differentiable by autograd as it stands, and
`*_bwd_plain`, the backward kernels' order). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel (`csrc/packed_conv.cu`,
`csrc/channel_sums.cu`) or raises. The wrappers count their launches
(`launches`, and `bwd_launches` for the backward). K11's bias and
weight gradients are fixed-order sums in both dtypes (per-block partials
over partitions fixed by the shape, `bwd_partials`, folded in order by
`csrc/fold.cuh`), and reproduce themselves bit for bit;
the channel sums are a fixed-order reduction (per-block
partials over a partition fixed by the shape, then a second launch that
adds them in order), so they reproduce themselves bit for bit
(`channel_sums_ordered` states that order in PyTorch). channel_sums'
backward, dx = ds1 + 2 x ds2, is plain PyTorch as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from lanedetection_end2end_tpu_torch.ops._build import (
    check_cuda, kernel, launch)
from lanedetection_end2end_tpu_torch.ops.nb1d import _conv3
from lanedetection_end2end_tpu_torch.ops.nb_block import (
    _SUM, _rounder, _transposed_taps, _wgrad3, dyv_split, wgrad_rows)

AXES = {"h": 0, "w": 1}
PLANE_DTYPES = (torch.bfloat16, torch.float32)


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def packed_conv_act_fwd_plain(x, k, b, axis: str, d: int, act: bool):
    """Plain forward of `packed_conv_act`: f32 convolution of x with the
    taps rounded to x's dtype, plus the f32 bias, relu, rounded to x's
    dtype."""
    y = _conv3(x.float(), _rounder(x.dtype)(k), AXES[axis], d) + b.float()
    if act:
        y = torch.relu(y)
    return y.to(x.dtype)


def packed_conv_act_bwd_plain(x, y, dy, k, axis: str, d: int, act: bool,
                              wgrad=_wgrad3):
    """Plain version of the backward kernels -> (dx, dk, db); dy in x's
    dtype. `wgrad` is the weight gradient (`_wgrad3`, full f32;
    `ops/tf32x3.py` has its TF32 forms)."""
    dz = dy.float()
    if act:
        dz = dz * (y > 0)
    dx = _conv3(dz, _transposed_taps(_rounder(x.dtype)(k)), AXES[axis], d)
    return (dx.to(x.dtype), wgrad(x.float(), dz, AXES[axis], d),
            dz.sum(_SUM))


def packed_conv_fwd_plain(x, k, axis: str, d: int) -> torch.Tensor:
    """Plain forward of `packed_conv`: f32, no bias."""
    return _conv3(x.float(), _rounder(x.dtype)(k), AXES[axis], d)


def packed_conv_bwd_plain(x, dy, k, axis: str, d: int, wgrad=_wgrad3):
    """Plain version of `packed_conv`'s backward kernels -> (dx, dk); dy
    f32, rounded to x's dtype first; `wgrad` as in
    `packed_conv_act_bwd_plain`."""
    dyr = dy.to(x.dtype).float()
    dx = _conv3(dyr, _transposed_taps(_rounder(x.dtype)(k)), AXES[axis], d)
    return dx.to(x.dtype), wgrad(x.float(), dyr, AXES[axis], d)


def channel_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (B, H, W, C) -> (2, C) f32."""
    xf = x.float().reshape(-1, x.shape[-1])
    return torch.stack([xf.sum(0), (xf * xf).sum(0)])


# ----------------------------------------------------------------------
# Kernel launches
# ----------------------------------------------------------------------

def _check_plane(x: torch.Tensor, name: str) -> Tuple[int, int, int, int]:
    B, H, W, C = x.shape
    if C not in (16, 64, 128):
        raise ValueError(f"packed_conv kernels: C={C} not in (16, 64, 128)")
    if x.dtype not in PLANE_DTYPES:
        raise TypeError(f"{name}: the packed_conv kernels take bfloat16 or "
                        f"float32 planes, got {x.dtype}")
    check_cuda(x, x.dtype, name=name)
    return B, H, W, C


def _cast_taps(k: torch.Tensor, dtype: torch.dtype, C: int) -> torch.Tensor:
    t = k.to(dtype).contiguous()
    check_cuda(t, dtype, (3, C, C), "k")
    return t


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _fwd_cuda(x, k, b, axis: str, d: int, act: bool) -> torch.Tensor:
    """Launch the forward: packed_conv_act with a bias `b`, packed_conv
    (f32 output) with b None."""
    B, H, W, C = _check_plane(x, "x")
    kc = _cast_taps(k, x.dtype, C)
    bf = None
    if b is not None:
        bf = b.float().contiguous()
        check_cuda(bf, torch.float32, (C,), "b")
    y = torch.empty(x.shape, device=x.device,
                    dtype=x.dtype if b is not None else torch.float32)
    launch(kernel("packed_conv", "ld_packed_conv_fwd", "pppp" + "i" * 8 + "p"),
           x.device, x.data_ptr(), kc.data_ptr(), _ptr(bf), y.data_ptr(),
           B, H, W, C, d, AXES[axis], int(x.dtype == torch.float32),
           int(act))
    (packed_conv_act if b is not None else packed_conv).launches += 1
    return y


def bwd_partials(shape, axis: str, dtype, bias: bool = True) -> int:
    """Floats of the backward's partials over a (B, H, W, C) plane of
    `dtype`: db (C a block of the dz pass, `nb_block.dyv_split`) with
    `bias`, and dk (3 C^2 a weight-gradient block, `nb_block.wgrad_rows`)."""
    B, H, W, C = shape
    db = dyv_split(C, B * H * W)[0] * C if bias else 0
    return db + wgrad_rows(shape, AXES[axis], dtype) * 3 * C * C


def packed_conv_bwd_kernel(x, y, dy, k, axis: str, d: int, act: bool,
                           bias: bool = True):
    """Launch the backward kernels on CUDA tensors -> (dx, dk, db), db None
    without `bias` (packed_conv: y None, dy already in x's dtype)."""
    B, H, W, C = _check_plane(x, "x")
    dy = dy.contiguous()
    check_cuda(dy, x.dtype, x.shape, "dy")
    if act:
        check_cuda(y, x.dtype, x.shape, "y")
    kT = _cast_taps(_transposed_taps(k), x.dtype, C)
    dz = torch.empty_like(x) if act else None
    dx = torch.empty_like(x)
    # dk and db written whole by the fold of the blocks' partials
    floats = bwd_partials(x.shape, axis, x.dtype, bias)
    part = torch.empty(floats, dtype=torch.float32, device=x.device)
    dk = torch.empty(3, C, C, dtype=torch.float32, device=x.device)
    db = (torch.empty(C, dtype=torch.float32, device=x.device) if bias
          else None)
    launch(kernel("packed_conv", "ld_packed_conv_bwd",
                  "p" * 9 + "i" * 9 + "p"),
           x.device, x.data_ptr(), dy.data_ptr(), _ptr(y if act else None),
           kT.data_ptr(), _ptr(dz), dx.data_ptr(), dk.data_ptr(), _ptr(db),
           part.data_ptr(), B, H, W, C, d, AXES[axis],
           int(x.dtype == torch.float32), int(act), floats)
    (packed_conv_act if bias else packed_conv).bwd_launches += 1
    return dx, dk, db


# ----------------------------------------------------------------------
# autograd
# ----------------------------------------------------------------------

class _PackedConvAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, b, axis, d, act):
        if x.device.type == "cpu":
            y = packed_conv_act_fwd_plain(x, k, b, axis, d, act)
        else:
            y = _fwd_cuda(x, k, b, axis, d, act)
        ctx.save_for_backward(x, k, y)
        ctx.conf = (axis, d, act)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, k, y = ctx.saved_tensors
        bwd = (packed_conv_act_bwd_plain if x.device.type == "cpu"
               else packed_conv_bwd_kernel)
        dx, dk, db = bwd(x, y, dy.to(x.dtype), k, *ctx.conf)
        return dx, dk.to(k.dtype), db, None, None, None


class _PackedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, axis, d):
        ctx.save_for_backward(x, k)
        ctx.conf = (axis, d)
        if x.device.type == "cpu":
            return packed_conv_fwd_plain(x, k, axis, d)
        return _fwd_cuda(x, k, None, axis, d, False)

    @staticmethod
    def backward(ctx, dy):
        x, k = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dk = packed_conv_bwd_plain(x, dy, k, *ctx.conf)
        else:
            dx, dk, _ = packed_conv_bwd_kernel(
                x, None, dy.to(x.dtype), k, *ctx.conf, act=False, bias=False)
        return dx, dk.to(k.dtype), None, None


def packed_conv_act(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor,
                    axis: str, d: int, act: bool) -> torch.Tensor:
    """One 3-tap convolution with its bias and, with `act`, relu:
    (B, H, W, C) -> (B, H, W, C) in x's dtype; k (3, C, C), b (C,)."""
    return _PackedConvAct.apply(x, k, b, axis, d, act)


def packed_conv(x: torch.Tensor, k: torch.Tensor, axis: str,
                d: int) -> torch.Tensor:
    """One 3-tap convolution without bias: (B, H, W, C) -> (B, H, W, C)
    f32; k (3, C, C)."""
    return _PackedConv.apply(x, k, axis, d)


# ----------------------------------------------------------------------
# channel_sums
# ----------------------------------------------------------------------

# csrc/channel_sums.cu: threads a block and 16-byte loads a thread
SUMS_THREADS, SUMS_LOADS = 256, 8


def channel_sums_blocks(npix: int, C: int, itemsize: int) -> int:
    """Blocks of the channel_sums kernel (partial-sum columns) over npix
    pixels of C channels of `itemsize` bytes: each owns SUMS_LOADS rounds
    of one 16-byte vector a thread."""
    per_block = SUMS_THREADS // (C * itemsize // 16) * SUMS_LOADS
    return -(-npix // per_block)


def _channel_sums_cuda(x: torch.Tensor) -> torch.Tensor:
    C = x.shape[-1]
    if C & (C - 1) or not 8 <= C <= 128:
        raise ValueError(f"channel_sums kernel: C={C} is not a power of "
                         "two in [8, 128]")
    f32 = x.dtype == torch.float32
    xp = check_cuda(x, torch.float32 if f32 else torch.bfloat16, name="x")
    npix = x.numel() // C
    part = torch.empty(2 * C * channel_sums_blocks(npix, C, x.element_size()),
                       dtype=torch.float32, device=x.device)
    out = torch.empty(2, C, dtype=torch.float32, device=x.device)
    launch(kernel("channel_sums", "ld_channel_sums", "pppiiip"), x.device,
           xp, part.data_ptr(), out.data_ptr(), npix, C, int(f32))
    channel_sums.launches += 1
    return out


class _ChannelSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.device.type == "cpu":
            return channel_sums_plain(x)
        return _channel_sums_cuda(x)

    @staticmethod
    def backward(ctx, dsums):
        (x,) = ctx.saved_tensors
        dx = dsums[0] + 2.0 * x.float() * dsums[1]
        return dx.to(x.dtype)


def channel_sums(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) bf16 or f32 -> (2, C) f32 [sum; sum of squares],
    differentiable. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    return _ChannelSums.apply(x)


for _f in (packed_conv_act, packed_conv):
    _f.launches = 0      # forward kernel launches
    _f.bwd_launches = 0  # backward kernel launches
channel_sums.launches = 0
