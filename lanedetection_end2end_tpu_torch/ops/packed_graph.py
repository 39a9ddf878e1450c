"""The differentiable training backbone on NHWC planes.

Counterpart of `lanedetection_end2end_tpu/ops/packed_graph.py` with
`PACKED_PALLAS=1`. The keyword `fused_blocks` of the functions below
chooses how the NonBottleneck1D blocks run, as the JAX package's
`PACKED_FUSED_BLOCKS` does:

- `fused_blocks=True` (the default, as in the JAX package): each block
  runs on the fused half-block kernels (`ops/nb_block.py`, K6 / K7),
  forward and backward, two launches each way;
- `fused_blocks=False` (`PACKED_FUSED_BLOCKS=0`): each block runs its
  four convolutions one by one on K11 (`packed_conv_act`,
  `ops/packed_conv.py`; `conv_h_train`, `conv_w_train`), with the bias,
  and relu after the 3x1 convolutions, in the kernel's epilogue, and its
  two train-mode BatchNorms take their moments from `channel_sums`. K11
  and `channel_sums` take float32 planes as well as bf16, so this path
  trains in the config's default float32 on the card.

The keyword `fused_maps` chooses how the stride-2 blocks run, as the JAX
package's `PACKED_FUSED_MAPS` does; left at None it follows
`fused_blocks`, as the JAX package's `_fused_maps_on` follows
`PACKED_FUSED_BLOCKS`, and an explicit value wins:

- `fused_maps=True` (the default with fused blocks): the downsamplers,
  the upsamplers and the 2x2 head run on the lane-map kernels of
  `ops/lanemaps.py` (`downsampler_op`, `lane_maps_op`), which also return
  the BatchNorm moments, and `head_rowsums_train` fuses the head with the
  e2e tail (`head_rowsums_op`), so the logits are never formed;
- `fused_maps=False` (`PACKED_FUSED_MAPS=0`): they are PyTorch autograd on
  operands of the compute dtype, with their train-mode BatchNorm moments
  from `channel_sums` (`ops/packed_conv.py`), and `rowsums` reduces the
  logits to the WLS row sums.

A tied 2x2 pooling window sends its gradient to one element. With
`fused_maps=True` it is the one the JAX package's where-chain picks (in
each column the upper row if >=, then the left column's winner if >=);
with `fused_maps=False` it is PyTorch's, the first maximum in row-major
order. The two agree on all-zero windows and differ on an exact tie between
(row 1, col 0) and (row 0, col 1).

The TPU's lane-packed (B, H, W*C) plane is the memory of an NHWC tensor
(B, H, W, C), which is what these functions take and return; the lane maps,
`kexp` and `sel` matrices that fill the TPU's 128 lanes are not ported.

The functions read the parameters of the reference modules
(`models/erfnet.py`, reference torch names and layouts) and update their
BatchNorm running statistics in place, with the JAX package's rule: the
*biased* batch variance mean(x^2) - mean(x)^2, momentum 0.9 on the old
value (`torch.nn.BatchNorm2d` would store the unbiased one).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lanedetection_end2end_tpu_torch.ops.lanemaps import (
    downsampler_op, head_rowsums_op, lane_maps_op)
from lanedetection_end2end_tpu_torch.ops.nb1d import _taps
from lanedetection_end2end_tpu_torch.ops.nb_block import nb_half_a, nb_half_b
from lanedetection_end2end_tpu_torch.ops.packed_conv import (
    channel_sums, packed_conv_act)
from lanedetection_end2end_tpu_torch.parallel.collectives import (
    all_reduce_mean)

BN_MOMENTUM = 0.9  # weight of the old running value


# ----------------------------------------------------------------------
# BatchNorm from moments, Dropout2d
# ----------------------------------------------------------------------

def bn_mul_add(mom: Optional[torch.Tensor], bn, n: int,
               train: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mul, add), f32, with y = x * mul + add the BatchNorm
    `bn` (a `torch.nn.BatchNorm2d`): from the batch moments `mom` (2, C) =
    [sum; sum of squares] over n values per channel in train mode, which
    also updates the running statistics in place; from the running
    statistics otherwise. Where `bn` has a `sync_group`
    (`parallel/collectives.py::set_sync_group`), the train-mode mean and
    mean of squares are averaged over its ranks first (JAX's pmean of the
    moments, `_bn_mul_add`)."""
    if train:
        group = getattr(bn, "sync_group", None)
        if group is None:
            mean, mean2 = mom[0] / n, mom[1] / n
        else:
            mean, mean2 = all_reduce_mean(mom / n, group).unbind(0)
        var = mean2 - mean * mean
        with torch.no_grad():
            bn.running_mean.mul_(BN_MOMENTUM).add_(
                mean.detach(), alpha=1.0 - BN_MOMENTUM)
            bn.running_var.mul_(BN_MOMENTUM).add_(
                var.detach(), alpha=1.0 - BN_MOMENTUM)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = bn.weight * torch.rsqrt(var + bn.eps)
    return mul, bn.bias - mean * mul


def batchnorm_train(x: torch.Tensor, bn, train: bool) -> torch.Tensor:
    """BatchNorm of an NHWC plane in its own dtype: moments from
    `channel_sums` (train) or the running statistics, then one multiply
    and add."""
    mom = channel_sums(x) if train else None
    mul, add = bn_mul_add(mom, bn, x.numel() // x.shape[-1], train)
    return x * mul.to(x.dtype) + add.to(x.dtype)


def dropout2d(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator], train: bool,
              channel_dim: int = -1) -> torch.Tensor:
    """torch.nn.Dropout2d with an explicit generator: whole channels drop
    per sample, the rest scale by 1 / keep. One (B, C) mask per call, drawn
    from `generator` on x's device; no generator means no dropout."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    B, C = x.shape[0], x.shape[channel_dim]
    mask = torch.rand(B, C, generator=generator, device=x.device) < keep
    shape = [B] + [1] * (x.dim() - 1)
    shape[channel_dim] = C
    return x * mask.to(x.dtype).view(shape) / keep


# ----------------------------------------------------------------------
# Blocks
# ----------------------------------------------------------------------

def conv_h_train(x: torch.Tensor, conv, act: bool = False) -> torch.Tensor:
    """The 3x1 convolution `conv` (a `torch.nn.Conv2d` (C, C, 3, 1) with
    its dilation) on an NHWC plane, bias and, with `act`, relu fused, in
    x's dtype: `packed_conv_act` (JAX `conv_h_packed(pallas=True)`)."""
    return packed_conv_act(x, _taps(conv.weight, 0), conv.bias, "h",
                           conv.dilation[0], act)


def conv_w_train(x: torch.Tensor, conv, act: bool = False) -> torch.Tensor:
    """The 1x3 convolution `conv` ((C, C, 1, 3)) likewise (JAX
    `conv_w_packed(pallas=True)`)."""
    return packed_conv_act(x, _taps(conv.weight, 1), conv.bias, "w",
                           conv.dilation[1], act)


def nb1d_train(x: torch.Tensor, block, *, train: bool, drop: float = 0.0,
               generator: Optional[torch.Generator] = None,
               fused_blocks: bool = True) -> torch.Tensor:
    """One NonBottleneck1D block (`models/erfnet.py::NonBottleneck1D`) on an
    NHWC plane. `fused_blocks=True`: half A -> BatchNorm-1 math -> half B
    -> BatchNorm-2 -> dropout -> residual relu, two kernel calls forward,
    two backward. `fused_blocks=False` (JAX `nb1d_packed` with
    `PACKED_FUSED_BLOCKS=0`): conv3x1 + relu, conv1x3, BatchNorm-1, relu,
    the dilated pair, BatchNorm-2, dropout, residual relu: four K11 calls
    and two `channel_sums` (train mode) forward, four K11 calls backward."""
    if not fused_blocks:
        y = conv_h_train(x, block.conv3x1_1, act=True)
        y = conv_w_train(y, block.conv1x3_1)
        y = torch.relu(batchnorm_train(y, block.bn1, train))
        y = conv_h_train(y, block.conv3x1_2, act=True)
        y = conv_w_train(y, block.conv1x3_2)
        y = batchnorm_train(y, block.bn2, train)
        y = dropout2d(y, drop, generator, train)
        return torch.relu(y + x)
    n = x.numel() // x.shape[-1]
    d = block.conv3x1_2.dilation[0]
    y2, mom1 = nb_half_a(x, _taps(block.conv3x1_1.weight, 0),
                         block.conv3x1_1.bias,
                         _taps(block.conv1x3_1.weight, 1),
                         block.conv1x3_1.bias)
    mul1, add1 = bn_mul_add(mom1, block.bn1, n, train)
    y4, mom2 = nb_half_b(y2, mul1, add1, _taps(block.conv3x1_2.weight, 0),
                         block.conv3x1_2.bias,
                         _taps(block.conv1x3_2.weight, 1),
                         block.conv1x3_2.bias, d)
    mul2, add2 = bn_mul_add(mom2, block.bn2, n, train)
    y = y4 * mul2.to(y4.dtype) + add2.to(y4.dtype)
    y = dropout2d(y, drop, generator, train)
    return torch.relu(y + x)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NCHW view of an NHWC tensor (channels-last strides)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC tensor from an NCHW result."""
    return x.permute(0, 2, 3, 1).contiguous()


def _bn_relu(y: torch.Tensor, mom: torch.Tensor, bn,
             train: bool) -> torch.Tensor:
    """BatchNorm from the op's moments, one multiply and add, relu."""
    mul, add = bn_mul_add(mom, bn, y.numel() // y.shape[-1], train)
    return torch.relu(y * mul.to(y.dtype) + add.to(y.dtype))


def downsampler_train(x: torch.Tensor, block, *, train: bool,
                      fused_maps: bool = True) -> torch.Tensor:
    """DownsamplerBlock: conv3x3/s2 || maxpool2x2, concat, BatchNorm, relu.
    (B, H, W, cin) -> (B, H/2, W/2, cout). `fused_maps=True` (the JAX
    default, `PACKED_FUSED_MAPS=1`) runs `downsampler_op` and routes a tied
    pooling window's gradient by the where-chain, rows first, then columns;
    `fused_maps=False` (`PACKED_FUSED_MAPS=0`) runs PyTorch's convolution
    and pool, which route it to the first maximum in row-major order."""
    if fused_maps:
        y, mom = downsampler_op(x, block.conv.weight, block.conv.bias)
        return _bn_relu(y, mom, block.bn, train)
    dt = x.dtype
    xc = _nchw(x)
    conv = F.conv2d(xc, block.conv.weight.to(dt), block.conv.bias.to(dt),
                    stride=2, padding=1)
    y = _nhwc(torch.cat([conv, F.max_pool2d(xc, 2, 2)], dim=1))
    return torch.relu(batchnorm_train(y, block.bn, train))


def upsampler_train(x: torch.Tensor, block, *, train: bool,
                    fused_maps: bool = True) -> torch.Tensor:
    """UpsamplerBlock: ConvTranspose 3x3/s2/p1/op1, BatchNorm, relu.
    (B, H, W, cin) -> (B, 2H, 2W, cout); on `lane_maps_op` with
    `fused_maps`."""
    if fused_maps:
        y, mom = lane_maps_op(x, block.conv.weight, block.conv.bias, 3)
        return _bn_relu(y, mom, block.bn, train)
    dt = x.dtype
    y = F.conv_transpose2d(_nchw(x), block.conv.weight.to(dt),
                           block.conv.bias.to(dt), stride=2, padding=1,
                           output_padding=1)
    return torch.relu(batchnorm_train(_nhwc(y), block.bn, train))


def head_train(x: torch.Tensor, conv, *,
               fused_maps: bool = True) -> torch.Tensor:
    """Output head, ConvTranspose 2x2/s2: (B, H, W, 16) -> (B, 2H, 2W, C)
    f32 logits; on `lane_maps_op` (f32 out, no moments) with `fused_maps`."""
    if fused_maps:
        return lane_maps_op(x, conv.weight, conv.bias, 2, torch.float32,
                            False)[0]
    dt = x.dtype
    y = F.conv_transpose2d(_nchw(x), conv.weight.to(dt), conv.bias.to(dt),
                           stride=2)
    return _nhwc(y).float()


# ----------------------------------------------------------------------
# Backbone and e2e tail
# ----------------------------------------------------------------------

def resolve_fused_maps(fused_blocks: bool,
                       fused_maps: Optional[bool]) -> bool:
    """`fused_maps` left at None follows `fused_blocks` (JAX
    `_fused_maps_on`); an explicit value wins."""
    return fused_blocks if fused_maps is None else fused_maps


def erfnet_train(net, images: torch.Tensor, *, train: bool,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 fused_blocks: bool = True,
                 fused_maps: Optional[bool] = None, skip_head: bool = False):
    """The backbone `net` (`models/erfnet.py::ERFNet`) on NHWC images
    (B, H, W, 3): returns (enc (B, H/8, W/8, 128) in `dtype`, logits
    (B, H, W, C) f32), or with `skip_head` the pre-head plane (B, H/2, W/2,
    16) in `dtype` in place of the logits, for a caller that fuses the head
    downstream (`head_rowsums_train`). Dropout (the encoder blocks' own
    rates) draws one mask per block from `generator`; the decoder has
    none. `fused_maps=None` follows `fused_blocks`."""
    fused_maps = resolve_fused_maps(fused_blocks, fused_maps)
    x = images.to(dtype)
    enc_mod, dec_mod = net.encoder, net.decoder
    x = downsampler_train(x, enc_mod.initial_block, train=train,
                          fused_maps=fused_maps)
    for layer in enc_mod.layers:
        if hasattr(layer, "conv3x1_1"):
            x = nb1d_train(x, layer, train=train, drop=layer.dropprob,
                           generator=generator, fused_blocks=fused_blocks)
        else:
            x = downsampler_train(x, layer, train=train,
                                  fused_maps=fused_maps)
    enc = x
    for layer in dec_mod.layers:
        if hasattr(layer, "conv3x1_1"):
            x = nb1d_train(x, layer, train=train, fused_blocks=fused_blocks)
        else:
            x = upsampler_train(x, layer, train=train, fused_maps=fused_maps)
    if skip_head:
        return enc, x
    return enc, head_train(x, dec_mod.output_conv, fused_maps=fused_maps)


def head_rowsums_train(x: torch.Tensor, conv, xs_norm: torch.Tensor,
                       zero_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused e2e tail on the pre-head plane (B, H/2, W/2, 16): output
    head, square activation, row mask and the WLS row sums in
    `head_rowsums_op`. Returns S0, S1 (B, C, H) f32 as `rowsums` does; the
    logits are never formed. Square activation only."""
    C = conv.weight.shape[1]
    S = head_rowsums_op(x, conv.weight, conv.bias, xs_norm, zero_rows)
    return S[..., :C].transpose(1, 2), S[..., C:].transpose(1, 2)


def rowsums(logits: torch.Tensor, act_fn, xs_norm: torch.Tensor,
            zero_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The e2e tail: w = act(logits), rows [0, zero_rows) masked, then the
    separable WLS row sums S0[b, c, h] = sum_w w^2 and S1 = sum_w w^2 *
    xs_norm[w], both (B, C, H) f32. logits (B, H, W, C) f32; xs_norm (W,)
    is the fitter's centered, normalized column coordinate."""
    w = act_fn(logits)
    w2 = w * w
    if zero_rows > 0:
        keep = torch.ones(logits.shape[1], 1, 1, device=logits.device)
        keep[:zero_rows] = 0.0
        w2 = w2 * keep
    S0 = w2.sum(dim=2).transpose(1, 2)
    S1 = (w2 * xs_norm[None, None, :, None]).sum(dim=2).transpose(1, 2)
    return S0, S1
