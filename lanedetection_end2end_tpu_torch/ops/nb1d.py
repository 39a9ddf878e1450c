"""K1 nb1d: one inference NonBottleneck1D block with BatchNorm folded.

Counterpart of `lanedetection_end2end_tpu/ops/pallas_nb1d.py` (`fold_bn`,
`pack_nb1d`, `_nb1d_body`). On NHWC bf16 (B, H, W, C), C in {16, 64, 128}:

    t = relu(conv3x1(x) + b1)            -> bf16
    t = relu(conv1x3(t) * m1 + a1)       -> bf16
    t = relu(conv3x1_d(t) + b3)          -> bf16
    y = relu(conv1x3_d(t) * m2 + a2 + x) -> bf16

f32 accumulation over bf16 operands, rounded to bf16 at the points the TPU
kernel rounds. The TPU's block-diagonal, banded and Winograd tap matrices
are lane-packing devices and are not ported: both versions here use the
direct 3-tap convolutions. `nb1d` launches the CUDA kernel
(`csrc/nb1d.cu`, two launches of a row tile: pass A the two d = 1
convolutions, pass B the two dilated ones and the residual; each pass runs
its 3x1 convolution into rows kept in shared memory and its 1x3 one from
them) for a CUDA tensor and uses `nb1d_plain` only for a CPU tensor. A
tile holds whole image rows, so the kernels take planes up to
`max_width(C)` = 8192 / C pixels wide.

`nb1d_chain` runs a chain of same-width blocks (`pack_chain`) as one
cooperative launch (`csrc/nb1d_chain.cu`, counterpart of JAX `nb1d_chain`)
on K1's device code, two grid passes a block: its output is bit for bit
that of `nb1d` block by block. `nb1d_chain_plain` is the loop of `nb1d_plain` over the blocks.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Sequence

import torch
import torch.nn.functional as F

from lanedetection_end2end_tpu_torch.ops._build import (
    check_cuda, kernel, launch)

BF16 = torch.bfloat16


def fold_bn(sd: Mapping[str, torch.Tensor], prefix: str, eps: float = 1e-3):
    """Inference BatchNorm `prefix` -> per-channel (mul, add), float32:
    y = (x - mean) / sqrt(var + eps) * weight + bias = x * mul + add."""
    f = lambda k: sd[f"{prefix}.{k}"].float()
    mul = f("weight") / torch.sqrt(f("running_var") + eps)
    return mul, f("bias") - f("running_mean") * mul


def _taps(weight: torch.Tensor, axis: int) -> torch.Tensor:
    """Conv2d weight (C, C, 3, 1) (axis 0) or (C, C, 1, 3) (axis 1) ->
    (3, ci, co)."""
    k = weight[:, :, :, 0] if axis == 0 else weight[:, :, 0, :]
    return k.permute(2, 1, 0)


def pack_nb1d(sd: Mapping[str, torch.Tensor], prefix: str,
              dilation: int) -> Dict:
    """Kernel constants of block `prefix` (reference torch names), on the
    device of `sd`:
      w   (4, 3, C, C) bf16: [conv3x1_1, conv1x3_1, conv3x1_2, conv1x3_2]
                             [tap][ci][co]
      vec (6, C) f32: b1, m1, a1, b3, m2, a2 with bn1(conv + b2) =
                      conv*m1 + a1 (a1 = b2*m1 + add1), likewise m2, a2."""
    g = lambda k: sd[f"{prefix}.{k}"]
    w = torch.stack([_taps(g("conv3x1_1.weight"), 0),
                     _taps(g("conv1x3_1.weight"), 1),
                     _taps(g("conv3x1_2.weight"), 0),
                     _taps(g("conv1x3_2.weight"), 1)])
    mul1, add1 = fold_bn(sd, f"{prefix}.bn1")
    mul2, add2 = fold_bn(sd, f"{prefix}.bn2")
    b = lambda k: g(f"{k}.bias").float()
    vec = torch.stack([b("conv3x1_1"), mul1, b("conv1x3_1") * mul1 + add1,
                       b("conv3x1_2"), mul2, b("conv1x3_2") * mul2 + add2])
    return {"w": w.to(BF16).contiguous(), "vec": vec.contiguous(),
            "dilation": int(dilation)}


def _conv3(t: torch.Tensor, w: torch.Tensor, axis: int, d: int):
    """f32 (B, H, W, C) -> f32 3-tap conv along H (axis 0) or W (axis 1)
    with dilation d and zero padding."""
    k = w.float().permute(2, 1, 0)                     # (co, ci, 3)
    if axis == 0:
        weight, pad, dil = k.unsqueeze(-1), (d, 0), (d, 1)
    else:
        weight, pad, dil = k.unsqueeze(2), (0, d), (1, d)
    y = F.conv2d(t.permute(0, 3, 1, 2), weight, padding=pad, dilation=dil)
    return y.permute(0, 2, 3, 1)


def nb1d_plain(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same function, same bf16
    rounding points, f32 convolutions."""
    w, v, d = p["w"], p["vec"], p["dilation"]
    rnd = lambda y: y.to(BF16).float()
    xf = x.float()
    y = rnd(torch.relu(_conv3(xf, w[0], 0, 1) + v[0]))
    y = rnd(torch.relu(_conv3(y, w[1], 1, 1) * v[1] + v[2]))
    y = rnd(torch.relu(_conv3(y, w[2], 0, d) + v[3]))
    y = torch.relu(_conv3(y, w[3], 1, d) * v[4] + v[5] + xf)
    return y.to(BF16).contiguous()


def max_width(C: int) -> int:
    """The widest plane the row tile of `csrc/nb1d.cuh` takes at C
    channels: a tile holds whole rows of 8192 / C pixels at most."""
    return 8192 // C


def _check_plane(name: str, C: int, W: int) -> None:
    if C not in (16, 64, 128):
        raise ValueError(f"{name} kernel: C={C} not in (16, 64, 128)")
    if W > max_width(C):
        raise ValueError(f"{name} kernel: rows of {W} pixels, the row tile "
                         f"takes at most {max_width(C)} at C={C}")


def nb1d(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """One NB1D block on (B, H, W, C) bf16. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (two pass launches) or
    raises."""
    if x.device.type == "cpu":
        return nb1d_plain(x, p)
    B, H, W, C = x.shape
    _check_plane("nb1d", C, W)
    xp = check_cuda(x, BF16, name="x")
    wp = check_cuda(p["w"], BF16, (4, 3, C, C), "w")
    vp = check_cuda(p["vec"], torch.float32, (6, C), "vec")
    out, mid = torch.empty_like(x), torch.empty_like(x)
    launch(kernel("nb1d", "ld_nb1d", "pppppiiiiip"), x.device, xp, wp, vp,
           mid.data_ptr(), out.data_ptr(), B, H, W, C, p["dilation"])
    nb1d.launches += 1
    return out


nb1d.launches = 0


def pack_chain(blocks: Sequence[Dict]) -> Dict:
    """`pack_nb1d` dicts of same-width blocks -> one chain: w (n, 4, 3, C,
    C) bf16, vec (n, 6, C) f32, dilations (n,) ints."""
    return {"w": torch.stack([p["w"] for p in blocks]).contiguous(),
            "vec": torch.stack([p["vec"] for p in blocks]).contiguous(),
            "dilations": tuple(p["dilation"] for p in blocks)}


def chain_blocks(chain: Dict):
    """The chain's blocks as `pack_nb1d` dicts (views of its tensors)."""
    return [{"w": w, "vec": v, "dilation": d}
            for w, v, d in zip(chain["w"], chain["vec"], chain["dilations"])]


def nb1d_chain_plain(x: torch.Tensor, chain: Dict) -> torch.Tensor:
    """Plain version of the chain kernel: `nb1d_plain` block after block."""
    for p in chain_blocks(chain):
        x = nb1d_plain(x, p)
    return x


MAX_CHAIN = 16  # blocks per launch (csrc/nb1d_chain.cu)


def nb1d_chain(x: torch.Tensor, chain: Dict) -> torch.Tensor:
    """The chain's blocks on (B, H, W, C) bf16. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (one cooperative
    launch for the whole chain) or raises. x is only read."""
    if x.device.type == "cpu":
        return nb1d_chain_plain(x, chain)
    B, H, W, C = x.shape
    dils = chain["dilations"]
    n = len(dils)
    _check_plane("nb1d_chain", C, W)
    if not 1 <= n <= MAX_CHAIN:
        raise ValueError(f"nb1d_chain kernel: {n} blocks not in "
                         f"1..{MAX_CHAIN}")
    xp = check_cuda(x, BF16, name="x")
    wp = check_cuda(chain["w"], BF16, (n, 4, 3, C, C), "w")
    vp = check_cuda(chain["vec"], torch.float32, (n, 6, C), "vec")
    out, mid, a = (torch.empty_like(x) for _ in range(3))
    launch(kernel("nb1d_chain", "ld_nb1d_chain", "ppppipppiiiip"),
           x.device, xp, wp, vp, (ctypes.c_int * n)(*dils), n,
           mid.data_ptr(), a.data_ptr(), out.data_ptr(), B, H, W, C)
    nb1d_chain.launches += 1
    return out


nb1d_chain.launches = 0
