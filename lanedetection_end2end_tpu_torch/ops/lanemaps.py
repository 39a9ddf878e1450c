"""K8 / K9 / K10: the stride-2 ops of the training backbone, forward and
backward.

Counterpart of `lanedetection_end2end_tpu/ops/pallas_lanemaps.py`
(`downsampler_op`, `lane_maps_op`, `head_rowsums_op`). On NHWC planes, with
the convolution weights in the layouts of the torch modules, all parameters
f32:

  downsampler_op(x, weight (cc, cin, 3, 3), bias (cc,)) -> (y, mom)
      y[..., :cc] = conv3x3/s2/p1(x) + bias;  y[..., cc:] = maxpool2x2(x)
  lane_maps_op(x, weight (cin, cout, k, k), bias, k, out_dtype, want_mom)
      -> (y, mom | None)
      y = ConvTranspose(x) + bias: k = 3 is 3x3/s2/p1/op1, k = 2 is 2x2/s2
  head_rowsums_op(x, weight (cin, C, 2, 2), bias, xs (W,), zero_rows) -> S
      dec = ConvTranspose2x2/s2(x) + bias in f32, never written;
      w2 = (dec^2)^2, rows [0, zero_rows) zero;
      S (B, H, 2C) f32 = [sum_w w2 | sum_w w2 * xs[w]]

`mom` is (2, cout) f32: the per-channel sum and sum of squares of y, which
the caller turns into the BatchNorm's scale and shift. The convolutions
read operands of the plane's dtype, accumulate in f32 and round once to the
output's dtype; the moments are taken of the rounded output. Each op is a
`torch.autograd.Function` whose backward follows the TPU backward kernels:
the moment cotangent `ds1 + 2 y ds2` folded into the output gradient in
f32, the bias gradient summed from that f32 value, then one rounding to the
plane's dtype ahead of the input and weight gradients. The input gradient
accumulates in f32 and is rounded once (the TPU kernels round every lane
map's product and sum in bf16). The weight gradients come out in the
parameters' layouts.

A tied 2x2 pooling window sends its gradient to one element, chosen as the
JAX package's where-chain chooses: in each column the upper row if it is
>= the lower, then the left column's winner if it is >= the right's.

A CUDA tensor launches the kernels (`csrc/downsampler_op.cu`,
`csrc/lane_maps_op.cu`, `csrc/head_rowsums_op.cu`; bf16 or float32 planes,
each dtype its own C entry, every plane of a call in one dtype, except that
bf16 planes may give an f32 `lane_maps_op` output) or raises; a CPU tensor
takes the plain versions below (`*_fwd_plain`, differentiable
by autograd as they stand, and `*_bwd_plain`, the kernels' order), in any
float dtype. The TPU's lane maps, `plan`, `sel`, `red`, `pool` and `btile`
matrices are lane-packing devices and are not ported.

The moments, the bias and the weight gradients of K8 and K9 are summed
with f32 atomicAdd, so their last bits change from run to run. K10 sums
its weight and bias gradients in a fixed order (per tile of
`HEAD_BWD_TILE` input pixels, then over the tiles), so they reproduce
themselves bit for bit, as S does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_weight

from lanedetection_end2end_tpu_torch.ops._build import (
    check_cuda, kernel, launch, plane_symbol)
from lanedetection_end2end_tpu_torch.ops.backbone import HEAD_CIN, _nhwc
from lanedetection_end2end_tpu_torch.ops.nb_block import (
    _SUM, _moments, _ptr, _rounder)

BF16 = torch.bfloat16
F32 = torch.float32
# the channels whose moments the kernels reduce (256 % C == 0); checked
# only where moments are asked for, so the 2x2 head takes any C <= 16
_MOM_CHANNELS = (4, 16, 64, 128)
# the (cin, cout) the kernels take at k = 3: K8 the config's three
# downsamplers, K9 its two upsamplers (on the tensor cores but for the
# first downsampler); K9 at k = 2 takes up to 16 channels each side
_DOWN_SHAPES = ((3, 16), (16, 64), (64, 128))
_UP_SHAPES = ((128, 64), (64, 16))
# input pixels a block of K10's backward owns, one column of partial sums
# each (csrc/head_rowsums_op.cu, TILE)
HEAD_BWD_TILE = 512


def _fold_moments(dy, y, dmom):
    """dy + ds1 + 2 y ds2 in f32 (dmom None: dy itself)."""
    dyv = dy.float()
    if dmom is not None:
        dyv = dyv + dmom[0] + 2.0 * y.float() * dmom[1]
    return dyv


def _convt_pad(k: int) -> dict:
    if k == 3:
        return {"stride": 2, "padding": 1, "output_padding": 1}
    if k == 2:
        return {"stride": 2}
    raise ValueError(f"lane_maps_op: k={k} not in (2, 3)")


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def _nchw_as_is(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)  # of any dtype: float64 references too


def conv_s2(large, w, k: int):
    """The k x k stride-2 convolution (k = 3: padding 1; k = 2: none) of a
    large NHWC plane (B, 2Hs, 2Ws, cl) with the parameter w (cs, cl, k, k)
    -> the small plane (B, Hs, Ws, cs), in the plane's float dtype
    (`gather_large` of the kernels)."""
    return _nhwc(F.conv2d(_nchw_as_is(large), w.to(large.dtype), stride=2,
                          padding=_convt_pad(k).get("padding", 0)))


def convt_s2(small, w, k: int):
    """Its transpose (k = 3 with output padding 1): (B, Hs, Ws, cs) ->
    (B, 2Hs, 2Ws, cl) (`gather_small`)."""
    return _nhwc(F.conv_transpose2d(_nchw_as_is(small), w.to(small.dtype),
                                    **_convt_pad(k)))


def wgrad_s2(small, large, k: int):
    """The weight gradient between the two planes: dW[cs, cl, ky, kx] = the
    sum over small pixels of small * large at the pixel the tap ties to it
    -> (cs, cl, k, k) (`wgrad_s2`)."""
    return conv2d_weight(_nchw_as_is(large), (small.shape[-1],
                                              large.shape[-1], k, k),
                         _nchw_as_is(small), stride=2,
                         padding=_convt_pad(k).get("padding", 0))


def _pool_chain(x: torch.Tensor):
    """2x2 max pool of an NHWC plane by the where-chain -> (p, m1, m2):
    m1 (B, H/2, W, C) keeps the upper row, m2 (B, H/2, W/2, C) the left
    column."""
    r0, r1 = x[:, 0::2], x[:, 1::2]
    m1 = r0 >= r1
    p1 = torch.where(m1, r0, r1)
    a, b = p1[:, :, 0::2], p1[:, :, 1::2]
    m2 = a >= b
    return torch.where(m2, a, b), m1, m2


def downsampler_fwd_plain(x, weight, bias, conv=conv_s2):
    """Plain PyTorch version of `downsampler_op` -> (y, mom). `conv` is the
    stride-2 convolution (`conv_s2`, full f32; `ops/tf32x3.py` has the
    float32 tiles' 3xTF32 arithmetic and its single-TF32 control)."""
    rnd = _rounder(x.dtype)
    xf = x.float()
    z = conv(xf, rnd(weight), 3) + bias.float()
    y = rnd(torch.cat([z, _pool_chain(xf)[0]], dim=-1))
    return y.to(x.dtype), _moments(y)


def downsampler_bwd_plain(x, y, dy, dmom, weight, need_dx: bool = True,
                          convt=convt_s2, wgrad=wgrad_s2):
    """Plain version of the backward kernels, in their order ->
    (dx | None, dweight, dbias); `convt` and `wgrad` as `conv` of the
    forward."""
    rnd = _rounder(x.dtype)
    cc = weight.shape[0]
    xf = x.float()
    dyv = _fold_moments(dy, y, dmom)
    dbias = dyv[..., :cc].sum(_SUM)
    dz = rnd(dyv)
    dzc = dz[..., :cc]
    dweight = wgrad(dzc, xf, 3)
    if not need_dx:
        return None, dweight, dbias
    dx = convt(dzc, rnd(weight), 3)
    _, m1, m2 = _pool_chain(xf)
    gp = dz[..., cc:]
    g_p1 = torch.stack([gp * m2, gp * ~m2], dim=3).flatten(2, 3)
    dx = dx + torch.stack([g_p1 * m1, g_p1 * ~m1], dim=2).flatten(1, 2)
    return dx.to(x.dtype), dweight, dbias


def lane_maps_fwd_plain(x, weight, bias, k: int, out_dtype=None,
                        want_mom: bool = True, convt=convt_s2):
    """Plain PyTorch version of `lane_maps_op` -> (y, mom | None); `convt`
    as `conv` of `downsampler_fwd_plain`."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    y = convt(x.float(), _rounder(x.dtype)(weight), k) + bias.float()
    y = _rounder(out_dtype)(y)
    return y.to(out_dtype), (_moments(y) if want_mom else None)


def _convt_grads(x, dp, weight, k: int, conv=conv_s2, wgrad=wgrad_s2):
    """Input and weight gradient of the transposed convolution from the
    rounded output gradient dp (B, 2H, 2W, cout), f32 values."""
    dx = conv(dp, _rounder(x.dtype)(weight), k)
    return dx.to(x.dtype), wgrad(x.float(), dp, k)


def lane_maps_bwd_plain(x, y, dy, dmom, weight, k: int, conv=conv_s2,
                        wgrad=wgrad_s2):
    """Plain version of the backward kernels -> (dx, dweight, dbias);
    y and dmom None when the op returned no moments; `conv` and `wgrad` as
    in `downsampler_bwd_plain`."""
    dyv = _fold_moments(dy, y, dmom)
    dx, dweight = _convt_grads(x, _rounder(x.dtype)(dyv), weight, k, conv,
                               wgrad)
    return dx, dweight, dyv.sum(_SUM)


def _head_sums(x) -> torch.dtype:
    """The head's sums: f32, float64 for a float64 plane (a reference)."""
    return torch.float64 if x.dtype == torch.float64 else F32


def _head_round(x):
    """Round to x's dtype where the kernels write it, back in the sums'
    dtype."""
    acc = _head_sums(x)
    return lambda t: t.to(x.dtype).to(acc)


def _head_dec(x, weight, bias):
    """Logits (B, C, H, W) of the 2x2/s2 head, f32 (float64 for a float64
    plane)."""
    acc = _head_sums(x)
    return F.conv_transpose2d(_nchw_as_is(x.to(acc)),
                              _head_round(x)(weight), bias.to(acc), stride=2)


def head_rowsums_fwd_plain(x, weight, bias, xs, zero_rows: int):
    """Plain PyTorch version of `head_rowsums_op` -> S (B, H, 2C) f32
    (float64 for a float64 plane)."""
    w2 = _head_dec(x, weight, bias).square().square()
    keep = torch.ones(w2.shape[2], 1, dtype=w2.dtype, device=x.device)
    keep[:zero_rows] = 0.0
    w2 = w2 * keep
    S = torch.cat([w2.sum(dim=3), (w2 * xs.to(w2.dtype)).sum(dim=3)], dim=1)
    return S.transpose(1, 2).contiguous()


def head_rowsums_bwd_plain(x, dS, weight, bias, xs, zero_rows: int):
    """Plain version of the backward kernels -> (dx, dweight, dbias): the
    logits recomputed, ddec = 4 dec^3 (dS0 + xs dS1) in f32 (float64 for a
    float64 plane), dp = ddec rounded to x's dtype, then the input and
    weight gradients of the transposed convolution from dp."""
    C = weight.shape[1]
    rnd = _head_round(x)
    dec = _head_dec(x, weight, bias)
    g = dS.to(dec.dtype).transpose(1, 2).unsqueeze(-1)   # (B, 2C, H, 1)
    ddec = 4.0 * dec * dec * dec * (g[:, :C] + xs.to(dec.dtype) * g[:, C:])
    ddec[:, :, :zero_rows] = 0.0
    dp = rnd(_nhwc(ddec))
    dx = conv_s2(dp, rnd(weight), 2).to(x.dtype)
    return dx, wgrad_s2(x.to(dec.dtype), dp, 2), ddec.sum((0, 2, 3))


# ----------------------------------------------------------------------
# Kernel launches
# ----------------------------------------------------------------------

def _check_weight(weight, bias, cs: int, cl: int, k: int):
    """The parameter (cs, cl, k, k) and its bias, f32 on the card."""
    w = weight.float().contiguous()
    b = bias.float().contiguous()
    check_cuda(w, F32, (cs, cl, k, k), "weight")
    check_cuda(b, F32, None, "bias")
    return w, b


def _taps_first(w: torch.Tensor, out_axis: int,
                dtype: torch.dtype) -> torch.Tensor:
    """(cs, cl, k, k) f32 -> (k, k, ., .) in the planes' `dtype` with the
    output channel of the product (axis `out_axis` of the parameter)
    last."""
    order = (2, 3, 1, 0) if out_axis == 0 else (2, 3, 0, 1)
    return w.permute(*order).to(dtype).contiguous()


def _check_plane(x: torch.Tensor, symbol: str) -> str:
    """Validate the input plane -> the C entry `symbol` for its dtype."""
    symbol = plane_symbol(symbol, x.dtype)
    check_cuda(x, x.dtype, name="x")
    return symbol


def _check_mom_channels(C: int, name: str):
    if C not in _MOM_CHANNELS:
        raise ValueError(f"{name}: {C} channels not in {_MOM_CHANNELS}")


def _check_shape(name: str, cin: int, cout: int, k: int = 3):
    """The channels of a stride-2 op: one of the shapes the kernels take."""
    shapes = _DOWN_SHAPES if name == "downsampler_op" else _UP_SHAPES
    if not ((cin, cout) in shapes if k == 3 else cin <= 16 and cout <= 16):
        raise ValueError(f"{name}: {cin} -> {cout} channels at k={k} is not "
                         "a shape the kernels take")


def _check_out_dtype(plane: torch.dtype, out: torch.dtype):
    """lane_maps_op writes bf16 or f32 from bf16 planes, f32 from f32."""
    if out not in ((BF16, F32) if plane == BF16 else (F32,)):
        raise TypeError(f"lane_maps_op: output dtype {out} from {plane} "
                        "planes")


def _dmom(dmom, C: int) -> Optional[torch.Tensor]:
    if dmom is None:
        return None
    dmom = dmom.float().contiguous()
    check_cuda(dmom, F32, (2, C), "dmom")
    return dmom


def _downsampler_fwd_cuda(x, weight, bias):
    B, H, W, cin = x.shape
    cc = weight.shape[0]
    cout = cc + cin
    symbol = _check_plane(x, "ld_downsampler_op_fwd")
    if H % 2 or W % 2:
        raise ValueError(f"downsampler_op: odd plane {H}x{W}")
    _check_shape("downsampler_op", cin, cout)
    w, b = _check_weight(weight, bias, cc, cin, 3)
    wt = _taps_first(w, 0, x.dtype)                       # (3, 3, cin, cc)
    y = torch.empty(B, H // 2, W // 2, cout, dtype=x.dtype, device=x.device)
    mom = torch.zeros(2, cout, dtype=F32, device=x.device)
    launch(kernel("downsampler_op", symbol, "p" * 5 + "i" * 5 + "p"),
           x.device, x.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(),
           mom.data_ptr(), B, H, W, cin, cout)
    downsampler_op.launches += 1
    return y, mom


def downsampler_bwd_kernel(x, y, dy, dmom, weight, need_dx: bool = True):
    """Launch the backward kernels on CUDA tensors; arguments and result as
    `downsampler_bwd_plain`."""
    B, H, W, cin = x.shape
    cc = weight.shape[0]
    cout = cc + cin
    symbol = _check_plane(x, "ld_downsampler_op_bwd")
    _check_shape("downsampler_op", cin, cout)
    dy = dy.contiguous()
    for t, name in ((y, "y"), (dy, "dy")):
        check_cuda(t, x.dtype, (B, H // 2, W // 2, cout), name)
    dmom = _dmom(dmom, cout)
    w = weight.float().contiguous()
    check_cuda(w, F32, (cc, cin, 3, 3), "weight")
    wt = _taps_first(w, 1, x.dtype)                       # (3, 3, cc, cin)
    dz = torch.empty_like(y)
    dx = torch.empty_like(x) if need_dx else None
    acc = torch.zeros(w.numel() + cout, dtype=F32, device=x.device)
    dweight, dbias = acc[:w.numel()].view_as(w), acc[w.numel():]
    launch(kernel("downsampler_op", symbol, "p" * 9 + "i" * 5 + "p"),
           x.device, x.data_ptr(), y.data_ptr(), dy.data_ptr(),
           dmom.data_ptr(), wt.data_ptr(), dz.data_ptr(), _ptr(dx),
           dweight.data_ptr(), dbias.data_ptr(), B, H, W, cin, cout)
    downsampler_op.bwd_launches += 1
    return dx, dweight, dbias[:cc]


def _lane_maps_fwd_cuda(x, weight, bias, k, out_dtype, want_mom):
    B, H, W, cin = x.shape
    cout = weight.shape[1]
    pad = _convt_pad(k).get("padding", 0)
    symbol = _check_plane(x, "ld_lane_maps_op_fwd")
    _check_out_dtype(x.dtype, out_dtype)
    if want_mom:
        _check_mom_channels(cout, "lane_maps_op")
    _check_shape("lane_maps_op", cin, cout, k)
    w, b = _check_weight(weight, bias, cin, cout, k)
    wt = _taps_first(w, 1, x.dtype)                       # (k, k, cin, cout)
    y = torch.empty(B, 2 * H, 2 * W, cout, dtype=out_dtype, device=x.device)
    mom = (torch.zeros(2, cout, dtype=F32, device=x.device) if want_mom
           else None)
    launch(kernel("lane_maps_op", symbol, "p" * 5 + "i" * 8 + "p"),
           x.device, x.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(),
           _ptr(mom), B, H, W, cin, cout, k, pad, int(out_dtype == F32))
    lane_maps_op.launches += 1
    return y, mom


def lane_maps_bwd_kernel(x, y, dy, dmom, weight, k: int):
    """Launch the backward kernels on CUDA tensors; arguments and result as
    `lane_maps_bwd_plain`."""
    B, H, W, cin = x.shape
    cout = weight.shape[1]
    pad = _convt_pad(k).get("padding", 0)
    symbol = _check_plane(x, "ld_lane_maps_op_bwd")
    if dmom is not None:
        _check_mom_channels(cout, "lane_maps_op")
    _check_shape("lane_maps_op", cin, cout, k)
    dy = dy.contiguous()
    _check_out_dtype(x.dtype, dy.dtype)
    check_cuda(dy, dy.dtype, (B, 2 * H, 2 * W, cout), "dy")
    dmom = _dmom(dmom, cout)
    if dmom is not None:
        check_cuda(y, dy.dtype, dy.shape, "y")
    w = weight.float().contiguous()
    check_cuda(w, F32, (cin, cout, k, k), "weight")
    wt = _taps_first(w, 0, x.dtype)                       # (k, k, cout, cin)
    dp = torch.empty(dy.shape, dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    acc = torch.zeros(w.numel() + cout, dtype=F32, device=x.device)
    dweight, dbias = acc[:w.numel()].view_as(w), acc[w.numel():]
    launch(kernel("lane_maps_op", symbol, "p" * 9 + "i" * 8 + "p"),
           x.device, x.data_ptr(), _ptr(y if dmom is not None else None),
           dy.data_ptr(), _ptr(dmom), wt.data_ptr(), dp.data_ptr(),
           dx.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), B, H, W, cin,
           cout, k, pad, int(dy.dtype == F32))
    lane_maps_op.bwd_launches += 1
    return dx, dweight, dbias


def _check_head(x, weight, bias, xs, symbol):
    """-> (weight, bias, xs on the card, the C entry `symbol` for x's
    dtype)."""
    B, Hh, Wh, cin = x.shape
    C = weight.shape[1]
    symbol = _check_plane(x, symbol)
    if C not in (1, 2, 4, 8):
        raise ValueError(f"head_rowsums_op: {C} lanes not in (1, 2, 4, 8)")
    if cin != HEAD_CIN:
        raise ValueError(f"head_rowsums_op: {cin} input channels, the "
                         f"kernel takes {HEAD_CIN}")
    w, b = _check_weight(weight, bias, cin, C, 2)
    xs = xs.float().contiguous()
    check_cuda(xs, F32, (2 * Wh,), "xs")
    return w, b, xs, symbol


def _head_rowsums_fwd_cuda(x, weight, bias, xs, zero_rows):
    B, Hh, Wh, cin = x.shape
    C = weight.shape[1]
    w, b, xs, symbol = _check_head(x, weight, bias, xs,
                                   "ld_head_rowsums_op_fwd")
    S = torch.empty(B, 2 * Hh, 2 * C, dtype=F32, device=x.device)
    launch(kernel("head_rowsums_op", symbol, "p" * 5 + "i" * 6 + "p"),
           x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(),
           xs.data_ptr(), S.data_ptr(), B, 2 * Hh, 2 * Wh, cin, C,
           int(zero_rows))
    head_rowsums_op.launches += 1
    return S


def head_rowsums_bwd_kernel(x, dS, weight, bias, xs, zero_rows: int):
    """Launch the backward kernels on CUDA tensors; arguments and result as
    `head_rowsums_bwd_plain`. One pass over x writes dx and one column of
    partial weight and bias gradients per tile of HEAD_BWD_TILE pixels; a
    second launch sums the columns in a fixed order. The kernels read the
    parameter as it lies and allocate no gradient plane."""
    B, Hh, Wh, cin = x.shape
    C = weight.shape[1]
    w, b, xs, symbol = _check_head(x, weight, bias, xs,
                                   "ld_head_rowsums_op_bwd")
    dS = dS.float().contiguous()
    check_cuda(dS, F32, (B, 2 * Hh, 2 * C), "dS")
    tiles = -(-B * Hh * Wh // HEAD_BWD_TILE)
    part = torch.empty((4 * cin + 1) * C * tiles, dtype=F32,
                       device=x.device)
    dx = torch.empty_like(x)
    dweight = torch.empty_like(w)
    dbias = torch.empty(C, dtype=F32, device=x.device)
    launch(kernel("head_rowsums_op", symbol, "p" * 9 + "i" * 6 + "p"),
           x.device, x.data_ptr(), dS.data_ptr(), w.data_ptr(),
           b.data_ptr(), xs.data_ptr(), part.data_ptr(), dx.data_ptr(),
           dweight.data_ptr(), dbias.data_ptr(), B, 2 * Hh, 2 * Wh, cin, C,
           int(zero_rows))
    head_rowsums_op.bwd_launches += 1
    return dx, dweight, dbias


# ----------------------------------------------------------------------
# autograd
# ----------------------------------------------------------------------

def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


class _Downsampler(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        fwd = downsampler_fwd_plain if _on_cpu(x) else _downsampler_fwd_cuda
        y, mom = fwd(x, weight, bias)
        ctx.save_for_backward(x, y, weight)
        return y, mom

    @staticmethod
    def backward(ctx, dy, dmom):
        x, y, weight = ctx.saved_tensors
        bwd = downsampler_bwd_plain if _on_cpu(x) else downsampler_bwd_kernel
        return bwd(x, y, dy, dmom, weight, ctx.needs_input_grad[0])


class _LaneMaps(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, k, out_dtype, want_mom):
        fwd = lane_maps_fwd_plain if _on_cpu(x) else _lane_maps_fwd_cuda
        y, mom = fwd(x, weight, bias, k, out_dtype, want_mom)
        ctx.save_for_backward(x, y if want_mom else None, weight)
        ctx.k = k
        return y, mom

    @staticmethod
    def backward(ctx, dy, dmom):
        x, y, weight = ctx.saved_tensors  # y None: no moments were taken
        bwd = lane_maps_bwd_plain if _on_cpu(x) else lane_maps_bwd_kernel
        dx, dweight, dbias = bwd(x, y, dy, dmom if y is not None else None,
                                 weight, ctx.k)
        return dx, dweight, dbias, None, None, None


class _HeadRowsums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, xs, zero_rows):
        fwd = head_rowsums_fwd_plain if _on_cpu(x) else _head_rowsums_fwd_cuda
        ctx.save_for_backward(x, weight, bias, xs)
        ctx.zero_rows = zero_rows
        return fwd(x, weight, bias, xs, zero_rows)

    @staticmethod
    def backward(ctx, dS):
        x, weight, bias, xs = ctx.saved_tensors
        bwd = head_rowsums_bwd_plain if _on_cpu(x) else head_rowsums_bwd_kernel
        dx, dweight, dbias = bwd(x, dS, weight, bias, xs, ctx.zero_rows)
        return dx, dweight, dbias, None, None


def downsampler_op(x, weight, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """DownsamplerBlock ahead of its BatchNorm: conv3x3/s2 || maxpool2x2 +
    bias, and the moments of the result. x (B, H, W, cin); returns
    (y (B, H/2, W/2, cc + cin), mom (2, cc + cin) f32). The input gradient
    is skipped when x needs none."""
    return _Downsampler.apply(x, weight, bias)


def lane_maps_op(x, weight, bias, k: int, out_dtype=None,
                 want_mom: bool = True):
    """ConvTranspose (k = 3: 3x3/s2/p1/op1, k = 2: 2x2/s2) + bias, written
    once at (B, 2H, 2W, cout) in `out_dtype` (default: x's), with the
    moments of the result when `want_mom` (else None)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    return _LaneMaps.apply(x, weight, bias, k, out_dtype, want_mom)


def head_rowsums_op(x, weight, bias, xs, zero_rows: int) -> torch.Tensor:
    """The 2x2/s2 head, the square activation, the top-row mask and the
    separable WLS row sums: (B, H/2, W/2, cin) -> S (B, H, 2C) f32, lanes
    [0, C) = S0 and [C, 2C) = S1."""
    return _HeadRowsums.apply(x, weight, bias, xs, zero_rows)


for _f in (downsampler_op, lane_maps_op, head_rowsums_op):
    _f.launches = 0      # forward kernel launches
    _f.bwd_launches = 0  # backward kernel launches
