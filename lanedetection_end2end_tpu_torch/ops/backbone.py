"""K2 downsampler, K3 upsampler and K4 head_rowsums: the non-NB1D blocks of
the serving backbone, each with its plain PyTorch version.

Counterpart of `lanedetection_end2end_tpu/ops/pallas_backbone.py`
(`body_downsampler`, `body_upsampler`, `body_head`) and of the activation,
row-mask and row-sum tail of `models/fused_graph.py::_decoder_plane_b`. The
TPU "lane maps" are lane-packing devices and are not ported: the kernels
(`csrc/downsampler.cu`, `csrc/upsampler.cu`, `csrc/head_rowsums.cu`)
compute the convolutions directly on NHWC bf16 with f32 accumulation, the
stride-2 ones on the tensor-core tiles of the training ops
(`csrc/conv_s2_mma.cuh`: the 3x3/s2 convolution as an implicit GEMM with
the pool channels from the same windows, the transposed convolution by
output parity) but the 3 -> 16 downsampler (FFMA, a thread per output
pixel). They take the backbone's shapes only: `DOWN_SHAPES`, `UP_SHAPES`.
Each wrapper uses its plain version only for a CPU tensor; for a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from lanedetection_end2end_tpu_torch.ops._build import (
    check_cuda, kernel, launch)
from lanedetection_end2end_tpu_torch.ops.activations import (
    ACTIVATIONS, activation_code, activation_fn)
from lanedetection_end2end_tpu_torch.ops.nb1d import fold_bn

BF16 = torch.bfloat16
F32 = torch.float32


# (cin, cout) of the downsamplers and upsamplers the kernels take
DOWN_SHAPES = ((3, 16), (16, 64), (64, 128))
UP_SHAPES = ((128, 64), (64, 16))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


# ----------------------------------------------------------------------
# K2: DownsamplerBlock (conv 3x3/s2 || maxpool 2x2, concat, BN, relu)
# ----------------------------------------------------------------------

def pack_downsampler(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict:
    """w (3, 3, cin, cc) bf16 [kh][kw][ci][co]; mul, add (cout,) f32 with
    the conv bias folded into the conv channels' add only."""
    weight = sd[f"{prefix}.conv.weight"]                  # (cc, cin, 3, 3)
    cc = weight.shape[0]
    mul, add = fold_bn(sd, f"{prefix}.bn")
    add = add.clone()
    add[:cc] += sd[f"{prefix}.conv.bias"].float() * mul[:cc]
    return {"w": weight.permute(2, 3, 1, 0).to(BF16).contiguous(),
            "mul": mul.contiguous(), "add": add.contiguous()}


def downsampler_plain(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """(B, H, W, cin) bf16 -> (B, H/2, W/2, cout) bf16, f32 inside."""
    xn = _nchw(x)
    conv = F.conv2d(xn, p["w"].float().permute(3, 2, 0, 1), stride=2,
                    padding=1)
    y = _nhwc(torch.cat([conv, F.max_pool2d(xn, 2, 2)], dim=1))
    return torch.relu(y * p["mul"] + p["add"]).to(BF16).contiguous()


def downsampler(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """DownsamplerBlock on (B, H, W, cin) bf16 -> (B, H/2, W/2, cout)."""
    if x.device.type == "cpu":
        return downsampler_plain(x, p)
    B, H, W, cin = x.shape
    cc = p["w"].shape[-1]
    cout = cc + cin
    if H % 2 or W % 2 or (cin, cout) not in DOWN_SHAPES:
        raise ValueError(f"downsampler kernel: plane {H}x{W}, {cin} -> "
                         f"{cout} channels, expected an even plane and one "
                         f"of {DOWN_SHAPES}")
    xp = check_cuda(x, BF16, name="x")
    wp = check_cuda(p["w"], BF16, (3, 3, cin, cc), "w")
    mp = check_cuda(p["mul"], F32, (cout,), "mul")
    ap = check_cuda(p["add"], F32, (cout,), "add")
    out = torch.empty(B, H // 2, W // 2, cout, dtype=BF16, device=x.device)
    launch(kernel("downsampler", "ld_downsampler", "pppppiiiiip"), x.device,
           xp, wp, mp, ap, out.data_ptr(), B, H, W, cin, cout)
    downsampler.launches += 1
    return out


downsampler.launches = 0


# ----------------------------------------------------------------------
# K3: UpsamplerBlock (ConvTranspose 3x3/s2/p1/op1, BN, relu)
# ----------------------------------------------------------------------

def pack_upsampler(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict:
    """w (3, 3, cin, cout) bf16 from the torch ConvTranspose2d weight
    (cin, cout, kH, kW), unflipped; mul, add (cout,) f32, bias folded."""
    mul, add = fold_bn(sd, f"{prefix}.bn")
    add = add + sd[f"{prefix}.conv.bias"].float() * mul
    w = sd[f"{prefix}.conv.weight"].permute(2, 3, 0, 1)
    return {"w": w.to(BF16).contiguous(), "mul": mul.contiguous(),
            "add": add.contiguous()}


def upsampler_plain(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """(B, H, W, cin) bf16 -> (B, 2H, 2W, cout) bf16, f32 inside."""
    y = F.conv_transpose2d(_nchw(x), p["w"].float().permute(2, 3, 0, 1),
                           stride=2, padding=1, output_padding=1)
    return torch.relu(_nhwc(y) * p["mul"] + p["add"]).to(BF16).contiguous()


def upsampler(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """UpsamplerBlock on (B, H, W, cin) bf16 -> (B, 2H, 2W, cout)."""
    if x.device.type == "cpu":
        return upsampler_plain(x, p)
    B, H, W, cin = x.shape
    cout = p["w"].shape[-1]
    if (cin, cout) not in UP_SHAPES:
        raise ValueError(f"upsampler kernel: {cin} -> {cout} channels, "
                         f"expected one of {UP_SHAPES}")
    xp = check_cuda(x, BF16, name="x")
    wp = check_cuda(p["w"], BF16, (3, 3, cin, cout), "w")
    mp = check_cuda(p["mul"], F32, (cout,), "mul")
    ap = check_cuda(p["add"], F32, (cout,), "add")
    out = torch.empty(B, 2 * H, 2 * W, cout, dtype=BF16, device=x.device)
    launch(kernel("upsampler", "ld_upsampler", "pppppiiiiip"), x.device,
           xp, wp, mp, ap, out.data_ptr(), B, H, W, cin, cout)
    upsampler.launches += 1
    return out


upsampler.launches = 0


# ----------------------------------------------------------------------
# K4: 2x2/s2 ConvTranspose head + activation + row mask + WLS row sums
# ----------------------------------------------------------------------

HEAD_CIN = 16  # the head's input channels (csrc/head_rowsums.cuh, CIN)


def pack_head(sd: Mapping[str, torch.Tensor], prefix: str, xs: torch.Tensor,
              zero_rows: int, activation: str) -> Dict:
    """w (2, 2, cin, C) bf16 from the torch weight (cin, C, 2, 2); bias (C,)
    f32; xs (W,) f32 normalized column coordinate of the fitter; rows
    [0, zero_rows) masked; `activation` one of ACTIVATIONS."""
    w = sd[f"{prefix}.weight"].permute(2, 3, 0, 1)
    return {"w": w.to(BF16).contiguous(),
            "bias": sd[f"{prefix}.bias"].float().contiguous(),
            "xs": xs.float().contiguous(), "zero_rows": int(zero_rows),
            "act": activation_code(activation)}


def head_rowsums_plain(t: torch.Tensor, p: Dict) -> torch.Tensor:
    """(B, H/2, W/2, cin) bf16 -> S (B, H, 2C) f32 = [S0 | S1]."""
    dec = F.conv_transpose2d(_nchw(t), p["w"].float().permute(2, 3, 0, 1),
                             p["bias"], stride=2)            # (B, C, H, W)
    w2 = activation_fn(ACTIVATIONS[p["act"]])(dec) ** 2
    S = torch.cat([w2.sum(dim=3), (w2 * p["xs"]).sum(dim=3)], dim=1)
    S = S.transpose(1, 2).contiguous()                       # (B, H, 2C)
    S[:, :p["zero_rows"]] = 0.0
    return S


def head_rowsums(t: torch.Tensor, p: Dict) -> torch.Tensor:
    """Head + activation + mask + row sums: (B, H/2, W/2, cin) bf16 ->
    (B, H, 2C) f32."""
    if t.device.type == "cpu":
        return head_rowsums_plain(t, p)
    B, Hh, Wh, cin = t.shape
    C = p["w"].shape[-1]
    H, W = 2 * Hh, 2 * Wh
    if cin != HEAD_CIN or not 1 <= C <= 8:
        raise ValueError(f"head_rowsums kernel: {cin} input channels and {C}"
                         f" lanes, the kernel takes {HEAD_CIN} and 1 to 8")
    tp = check_cuda(t, BF16, name="t")
    wp = check_cuda(p["w"], BF16, (2, 2, cin, C), "w")
    bp = check_cuda(p["bias"], F32, (C,), "bias")
    xsp = check_cuda(p["xs"], F32, (W,), "xs")
    S = torch.empty(B, H, 2 * C, dtype=F32, device=t.device)
    launch(kernel("head_rowsums", "ld_head_rowsums", "pppppiiiiiiip"),
           t.device, tp, wp, bp, xsp, S.data_ptr(), B, H, W, cin, C,
           p["zero_rows"], p["act"])
    head_rowsums.launches += 1
    return S


head_rowsums.launches = 0
