"""channel_sums: one-pass per-channel batch moments of an NHWC plane.

Counterpart of `channel_sums` in
`lanedetection_end2end_tpu/ops/pallas_packed_conv.py`: the train-mode
BatchNorm statistics of the downsamplers and upsamplers. For x of shape
(B, H, W, C):

    sums[0, c] = sum x[..., c],   sums[1, c] = sum x[..., c]^2     (f32)

The TPU's (128, 128) `sel` matrix folds packed lanes onto channels and is
not ported: the result is (2, C). The backward is elementwise,
dx = ds1 + 2 x ds2, in plain PyTorch as in the JAX package. `channel_sums`
launches the CUDA kernel (`csrc/channel_sums.cu`) for a CUDA tensor and
uses `channel_sums_plain` only for a CPU tensor.
"""

from __future__ import annotations

import torch

from lanedetection_end2end_tpu_torch.ops._build import (
    check_cuda, kernel, launch)


def channel_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (B, H, W, C) -> (2, C) f32."""
    xf = x.float().reshape(-1, x.shape[-1])
    return torch.stack([xf.sum(0), (xf * xf).sum(0)])


def _channel_sums_cuda(x: torch.Tensor) -> torch.Tensor:
    C = x.shape[-1]
    if C % 8 or not 8 <= C <= 128:
        raise ValueError(f"channel_sums kernel: C={C} is not a multiple of "
                         "8 in [8, 128]")
    xp = check_cuda(x, torch.bfloat16, name="x")
    out = torch.zeros(2, C, dtype=torch.float32, device=x.device)
    launch(kernel("channel_sums", "ld_channel_sums", "ppiip"), x.device,
           xp, out.data_ptr(), x.numel() // C, C)
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
    """(B, H, W, C) -> (2, C) f32 [sum; sum of squares], differentiable. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    return _ChannelSums.apply(x)


channel_sums.launches = 0
