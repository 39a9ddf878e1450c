"""K6 / K7: the fused halves of a training NonBottleneck1D block.

Counterpart of `lanedetection_end2end_tpu/ops/pallas_nb_block.py`
(`nb_half_a`, `nb_half_b`). On NHWC planes (B, H, W, C), taps (3, ci, co)
with tap 0 on the row or column at -d, biases (C,), all parameters f32:

  nb_half_a(x, kh, bh, kw, bw) -> (y2, mom)
      y1 = relu(conv3x1(x) + bh);  y2 = conv1x3(y1) + bw
  nb_half_b(y2, mul, add, kh, bh, kw, bw, d) -> (y4, mom)
      z  = relu(y2 * mul + add)            (the BatchNorm-1 normalize)
      y3 = relu(conv3x1_d(z) + bh);  y4 = conv1x3_d(y3) + bw

`mom` is (2, C) f32: the per-channel sum and sum of squares of the output,
which the caller turns into the next BatchNorm's scale and shift. Every
convolution reads operands of the plane's dtype, accumulates in f32 and
rounds to the plane's dtype; the moments are taken of the rounded output.
Both are `torch.autograd.Function`s whose backward follows the TPU backward
kernels step by step, with the moment cotangent `ds1 + 2 y ds2` folded into
the output gradient and, for half B, the prologue recomputed.

A CUDA tensor launches the kernels (`csrc/nb_half_fwd.cu`,
`csrc/nb_half_bwd.cu`; bf16 or float32 planes, each dtype its own C entry,
every plane of a call in one dtype, C in {16, 64, 128}) or raises; a CPU
tensor takes the plain versions below (`half_fwd_plain`, `half_bwd_plain`),
forward and backward, in any float dtype. The TPU's block-diagonal `kexp`, `sel` and banded W-conv matrices
are lane-packing devices and are not ported.

The weight and bias gradients of the kernels are summed with f32
atomicAdd, so their last bits change from run to run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from lanedetection_end2end_tpu_torch.ops._build import (
    check_cuda, kernel, launch, plane_symbol)
from lanedetection_end2end_tpu_torch.ops.nb1d import _conv3

_SUM = (0, 1, 2)  # the pixel axes of an NHWC plane


def _rounder(dtype):
    """Round an f32 tensor to the plane's dtype and back (identity for
    f32): the points where the kernels write bf16."""
    return lambda t: t.to(dtype).float()


def _transposed_taps(k: torch.Tensor) -> torch.Tensor:
    """Taps of the transposed convolution: kT[t] = k[2 - t]^T, so that
    dx[q] = sum_t dy[q + (t-1)d] @ kT[t]."""
    return k.flip(0).transpose(1, 2)


def _shift(a: torch.Tensor, off: int, dim: int) -> torch.Tensor:
    """result[p] = a[p + off] along `dim`, zero where that falls off."""
    n = a.shape[dim]
    if off == 0:
        return a
    if abs(off) >= n:
        return torch.zeros_like(a)
    pad = torch.zeros_like(a.narrow(dim, 0, abs(off)))
    if off > 0:
        return torch.cat([a.narrow(dim, off, n - off), pad], dim)
    return torch.cat([pad, a.narrow(dim, 0, n + off)], dim)


def _wgrad3(a: torch.Tensor, dy: torch.Tensor, axis: int, d: int):
    """dk[t] = shift_t(a)^T @ dy over all pixels -> (3, ci, co) f32."""
    return torch.stack([
        torch.einsum("bhwi,bhwo->io", _shift(a, (t - 1) * d, 1 + axis), dy)
        for t in range(3)])


def _moments(y: torch.Tensor) -> torch.Tensor:
    return torch.stack([y.sum(_SUM), (y * y).sum(_SUM)])


# ----------------------------------------------------------------------
# Plain versions: forward (differentiable by autograd as it stands) and
# the explicit backward in the kernels' order
# ----------------------------------------------------------------------

def half_fwd_plain(x, mul, add, kh, bh, kw, bw, d: int, conv=_conv3):
    """Plain forward of either half -> (yout, ymid, mom): both stashes, as
    the forward kernel writes them. mul/add None for half A. `conv` is the
    3-tap convolution (`_conv3`, full f32; `ops/tf32x3.py` has its TF32
    forms)."""
    rnd = _rounder(x.dtype)
    z = x.float()
    if mul is not None:
        z = rnd(torch.relu(z * mul + add))
    ymid = rnd(torch.relu(conv(z, rnd(kh), 0, d) + bh))
    yout = rnd(conv(ymid, rnd(kw), 1, d) + bw)
    return yout.to(x.dtype), ymid.to(x.dtype), _moments(yout)


def half_bwd_plain(x, mul, add, ymid, yout, dyout, dmom, kh, kw, d: int,
                   conv=_conv3, wgrad=_wgrad3):
    """Plain version of the backward kernels, in their order ->
    (dx, dmul, dadd, dkh, dbh, dkw, dbw); dmul/dadd None for half A.
    `conv` as in `half_fwd_plain`, for the two input gradients; `wgrad`
    the weight gradient (`_wgrad3`, full f32; `ops/tf32x3.py` has its TF32
    forms)."""
    rnd = _rounder(x.dtype)
    xf, ymid_f = x.float(), ymid.float()
    z = xf
    if mul is not None:
        zf = xf * mul + add
        z = rnd(torch.relu(zf))
    dyv = dyout.float() + dmom[0] + 2.0 * yout.float() * dmom[1]
    dbw = dyv.sum(_SUM)
    dy = rnd(dyv)
    dkw = wgrad(ymid_f, dy, 1, d)
    dmid_f = conv(dy, _transposed_taps(rnd(kw)), 1, d) * (ymid_f > 0)
    dbh = dmid_f.sum(_SUM)
    dmid = rnd(dmid_f)
    dkh = wgrad(z, dmid, 0, d)
    dz = conv(dmid, _transposed_taps(rnd(kh)), 0, d)
    if mul is None:
        return dz.to(x.dtype), None, None, dkh, dbh, dkw, dbw
    dz = dz * (zf > 0)
    return ((dz * mul).to(x.dtype), (dz * xf).sum(_SUM), dz.sum(_SUM),
            dkh, dbh, dkw, dbw)


def nb_half_a_plain(x, kh, bh, kw, bw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `nb_half_a`; autograd differentiates it."""
    yout, _, mom = half_fwd_plain(x, None, None, kh, bh, kw, bw, 1)
    return yout, mom


def nb_half_b_plain(y2, mul, add, kh, bh, kw, bw, d: int):
    """Plain PyTorch version of `nb_half_b`; autograd differentiates it."""
    yout, _, mom = half_fwd_plain(y2, mul, add, kh, bh, kw, bw, d)
    return yout, mom


# ----------------------------------------------------------------------
# Kernel launches
# ----------------------------------------------------------------------

def _check_plane(x: torch.Tensor, symbol: str):
    """-> (B, H, W, C, the C entry `symbol` for x's dtype)."""
    B, H, W, C = x.shape
    if C not in (16, 64, 128):
        raise ValueError(f"nb_half kernels: C={C} not in (16, 64, 128)")
    symbol = plane_symbol(symbol, x.dtype)
    check_cuda(x, x.dtype, name="x")
    return B, H, W, C, symbol


def _muladd(mul, add, C: int) -> Optional[torch.Tensor]:
    if mul is None:
        return None
    t = torch.stack([mul, add]).float().contiguous()
    check_cuda(t, torch.float32, (2, C), "mul/add")
    return t


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _half_fwd_cuda(x, mul, add, kh, bh, kw, bw, d: int):
    B, H, W, C, symbol = _check_plane(x, "ld_nb_half_fwd")
    khb, kwb = kh.to(x.dtype).contiguous(), kw.to(x.dtype).contiguous()
    bhf, bwf = bh.float().contiguous(), bw.float().contiguous()
    for t, shape, name in ((khb, (3, C, C), "kh"), (kwb, (3, C, C), "kw")):
        check_cuda(t, x.dtype, shape, name)
    for t, name in ((bhf, "bh"), (bwf, "bw")):
        check_cuda(t, torch.float32, (C,), name)
    ma = _muladd(mul, add, C)
    ymid, yout = torch.empty_like(x), torch.empty_like(x)
    mom = torch.zeros(2, C, dtype=torch.float32, device=x.device)
    launch(kernel("nb_half_fwd", symbol, "pppppppppiiiiip"),
           x.device, x.data_ptr(), khb.data_ptr(), bhf.data_ptr(),
           kwb.data_ptr(), bwf.data_ptr(), _ptr(ma), ymid.data_ptr(),
           yout.data_ptr(), mom.data_ptr(), B, H, W, C, d)
    (nb_half_a if mul is None else nb_half_b).launches += 1
    return yout, ymid, mom


def half_bwd_kernel(x, mul, add, ymid, yout, dyout, dmom, kh, kw, d: int):
    """Launch the backward kernels on CUDA tensors; arguments and result as
    `half_bwd_plain`."""
    B, H, W, C, symbol = _check_plane(x, "ld_nb_half_bwd")
    dyout = dyout.contiguous()
    for t, name in ((ymid, "ymid"), (yout, "yout"), (dyout, "dyout")):
        check_cuda(t, x.dtype, x.shape, name)
    dmom = dmom.float().contiguous()
    check_cuda(dmom, torch.float32, (2, C), "dmom")
    khT = _transposed_taps(kh).to(x.dtype).contiguous()
    kwT = _transposed_taps(kw).to(x.dtype).contiguous()
    ma = _muladd(mul, add, C)
    dyv, dmid, dx = (torch.empty_like(x) for _ in range(3))
    # one zeroed f32 buffer for everything the kernels accumulate into
    n_k, f32 = 3 * C * C, torch.float32
    acc = torch.zeros(2 * n_k + 4 * C, dtype=f32, device=x.device)
    dkh, dkw = acc[:n_k].view(3, C, C), acc[n_k:2 * n_k].view(3, C, C)
    dbh, dbw = acc[2 * n_k:2 * n_k + C], acc[2 * n_k + C:2 * n_k + 2 * C]
    dma = acc[2 * n_k + 2 * C:].view(2, C) if ma is not None else None
    launch(kernel("nb_half_bwd", symbol, "p" * 16 + "iiiiip"),
           x.device, x.data_ptr(), _ptr(ma), ymid.data_ptr(),
           yout.data_ptr(), dyout.data_ptr(), dmom.data_ptr(),
           khT.data_ptr(), kwT.data_ptr(), dyv.data_ptr(), dmid.data_ptr(),
           dx.data_ptr(), dkh.data_ptr(), dbh.data_ptr(), dkw.data_ptr(),
           dbw.data_ptr(), _ptr(dma), B, H, W, C, d)
    (nb_half_a if mul is None else nb_half_b).bwd_launches += 1
    if dma is None:
        return dx, None, None, dkh, dbh, dkw, dbw
    return dx, dma[0], dma[1], dkh, dbh, dkw, dbw


# ----------------------------------------------------------------------
# autograd
# ----------------------------------------------------------------------

class _NBHalf(torch.autograd.Function):
    """One half block; `mul`/`add` are None for half A."""

    @staticmethod
    def forward(ctx, x, mul, add, kh, bh, kw, bw, d):
        fwd = half_fwd_plain if x.device.type == "cpu" else _half_fwd_cuda
        yout, ymid, mom = fwd(x, mul, add, kh, bh, kw, bw, d)
        ctx.save_for_backward(x, mul, add, ymid, yout, kh, kw)
        ctx.d = d
        return yout, mom

    @staticmethod
    def backward(ctx, dyout, dmom):
        x, mul, add, ymid, yout, kh, kw = ctx.saved_tensors
        bwd = half_bwd_plain if x.device.type == "cpu" else half_bwd_kernel
        dx, dmul, dadd, dkh, dbh, dkw, dbw = bwd(
            x, mul, add, ymid, yout, dyout.to(x.dtype), dmom, kh, kw, ctx.d)
        return dx, dmul, dadd, dkh, dbh, dkw, dbw, None


def nb_half_a(x, kh, bh, kw, bw) -> Tuple[torch.Tensor, torch.Tensor]:
    """First NB1D half: relu(conv3x1(x) + bh) -> conv1x3(.) + bw, and the
    moments of the result. x (B, H, W, C); returns (y2, mom (2, C) f32)."""
    return _NBHalf.apply(x, None, None, kh, bh, kw, bw, 1)


def nb_half_b(y2, mul, add, kh, bh, kw, bw,
              d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Second NB1D half with the BatchNorm-1 normalize + relu as its
    prologue and dilation d. mul/add (C,) f32; returns (y4, mom)."""
    return _NBHalf.apply(y2, mul, add, kh, bh, kw, bw, d)


for _f in (nb_half_a, nb_half_b):
    _f.launches = 0      # forward kernel launches
    _f.bwd_launches = 0  # backward kernel launches
