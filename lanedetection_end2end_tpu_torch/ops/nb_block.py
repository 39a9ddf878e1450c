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

In both dtypes every block of the kernels writes its sums (the moments,
the weight and bias gradients) to a row of a partials scratch (the
wrappers size it from the kernels' block partitions, which depend on the
shape alone: `fwd_partials`, `bwd_partials`) and one more launch adds
the rows in a fixed order (`csrc/fold.cuh`, `ops/fold.py`), so the sums
reproduce themselves bit for bit and need no zero fill.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lanedetection_end2end_tpu_torch.ops._build import (
    check_cuda, kernel, launch, plane_symbol)
from lanedetection_end2end_tpu_torch.ops.fold import cdiv, ew_rows, split_rows
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

# ----------------------------------------------------------------------
# The kernels' block partitions (float32: csrc/conv3tap_f32.cuh; bf16:
# csrc/conv3tap.cuh, csrc/wgrad3tap.cuh; both: csrc/nb_half_bwd.cu's dyv
# pass): the rows of their partials
# ----------------------------------------------------------------------

WG_PER_TAP = {16: 132, 64: 88, 128: 44}  # weight-gradient blocks a tap
WG_CHUNK = {16: 128, 64: 32, 128: 32}    # its pixels a chunk

# The float32 convolution tile: persistent blocks of F32_CONV[C][0]
# independent warpgroups walking tiles of F32_CONV[C][1] pixels of one
# image (the bf16 tiles' `TileGeo` and walk), at most one wave (BF16_WAVE
# blocks); K in products of F32_KC[C] input channels of all three taps,
# the tap matrices split once a launch into `f32_planes(C)` floats of the
# partials scratch that no fold reads
F32_CONV = {16: (4, 64), 64: (2, 128), 128: (2, 64)}  # (warpgroups, BM)
F32_KC = {16: 16, 64: 8, 128: 8}

# The bf16 tiles: persistent blocks walking tiles of one image (8 rows x
# BM / 8 columns for the row taps, axis 0; BM columns of a row for the
# column taps, axis 1), at most one wave of the H100's 132 SMs at the
# convolution's one block an SM and the weight gradient's two; the weight
# gradient's blocks add their sums in clusters of BF16_WG_CLUSTER[C], a
# row of partials a cluster
BF16_WAVE = 132                              # convolution blocks
BF16_CONV = {16: (4, 128), 64: (4, 64), 128: (2, 64)}  # (warpgroups, BM)
BF16_WG_BLOCKS = {16: 264, 64: 264, 128: 44}  # weight gradient (a tap)
BF16_WG_BM = 64
BF16_WG_CLUSTER = {16: 1, 64: 2, 128: 1}


def conv_rows(shape, axis: int) -> int:
    """Blocks of the float32 convolution over a (B, H, W, C) plane (its
    taps on `axis`): a warpgroup a tile at most, at most BF16_WAVE;
    warpgroup w of block b takes tiles b NWG + w + k NWG blocks."""
    nwg, bm = F32_CONV[shape[-1]]
    return min(cdiv(bf16_tiles(shape, axis, bm), nwg), BF16_WAVE)


def f32_planes(C: int) -> int:
    """Floats of the float32 convolution's split tap matrices: for each
    chunk of F32_KC[C] input channels and tap, a TF32 hi and lo plane of
    F32_KC[C] x C (`csrc/conv3tap_f32.cuh::wsplit_f32_kernel`)."""
    return 6 * C * C


def wgrad_split(C: int, npix: int) -> tuple:
    """(blocks a tap, pixels a block) of the float32 weight gradient:
    whole chunks of WG_CHUNK[C] pixels over WG_PER_TAP[C] blocks a tap."""
    blocks, cpb = split_rows(cdiv(npix, WG_CHUNK[C]), WG_PER_TAP[C])
    return blocks, cpb * WG_CHUNK[C]


def dyv_split(C: int, npix: int) -> tuple:
    """(blocks, pixels a block and round) of the backward's dyv pass (and
    of K11's dz pass): a grid-stride walk, block b taking pixels b * RPI +
    [0, RPI) of each round of blocks * RPI."""
    rpi = 256 // (C // 8)
    return ew_rows(npix, rpi), rpi


def bf16_tiles(shape, axis: int, bm: int) -> int:
    """Tiles of BM pixels of the 3-tap tiles' geometry (`TileGeo`, bf16 and
    float32) over a (B, H, W, C) plane."""
    B, H, W, _ = shape
    th = 8 if axis == 0 else 1
    return B * cdiv(H, th) * cdiv(W, bm // th)


def bf16_conv_rows(shape, axis: int) -> int:
    """Blocks of the bf16 convolution: a warpgroup a tile at most, at most
    BF16_WAVE; warpgroup w of block b takes tiles b NWG + w + k NWG
    blocks."""
    nwg, bm = BF16_CONV[shape[-1]]
    return min(cdiv(bf16_tiles(shape, axis, bm), nwg), BF16_WAVE)


def bf16_wgrad_grid(shape, axis: int) -> int:
    """Blocks (a tap at C = 128) of the bf16 weight gradient: at most
    BF16_WG_BLOCKS, rounded up to whole clusters; block b takes the
    64-pixel tiles b + k blocks."""
    C = shape[-1]
    blocks = min(bf16_tiles(shape, axis, BF16_WG_BM), BF16_WG_BLOCKS[C])
    return cdiv(blocks, BF16_WG_CLUSTER[C]) * BF16_WG_CLUSTER[C]


def bf16_wgrad_rows(shape, axis: int) -> int:
    """Rows of the bf16 weight gradient's partials: one a cluster of
    BF16_WG_CLUSTER[C] blocks (blocks b K .. b K + K - 1 make row b)."""
    return bf16_wgrad_grid(shape, axis) // BF16_WG_CLUSTER[shape[-1]]


def sum_rows(shape, axis: int, dtype) -> int:
    """Rows of a convolution's sums over a (B, H, W, C) plane of `dtype`
    (its taps on `axis`)."""
    if dtype == torch.float32:
        return conv_rows(shape, axis)
    return bf16_conv_rows(shape, axis)


def wgrad_rows(shape, axis: int, dtype) -> int:
    """Rows of 3 C^2 floats of a weight gradient's partials."""
    if dtype == torch.float32:
        return wgrad_split(shape[-1], shape[0] * shape[1] * shape[2])[0]
    return bf16_wgrad_rows(shape, axis)


def conv_space(C: int, dtype) -> int:
    """Floats of the scratch a convolution takes besides its sums: the
    float32 tile's split tap matrices, none in bf16."""
    return f32_planes(C) if dtype == torch.float32 else 0


def fwd_partials(shape, dtype) -> int:
    """Floats of the forward's partials over a (B, H, W, C) plane: the
    moments' 2C a block of the second convolution (column taps), and in
    float32 the two convolutions' split tap matrices."""
    C = shape[-1]
    return 2 * C * sum_rows(shape, 1, dtype) + 2 * conv_space(C, dtype)


def bwd_partials(shape, half_b: bool, dtype) -> int:
    """Floats of the backward's partials, in the kernels' order: dbw (C a
    dyv block), dkw (3 C^2 a weight-gradient block, column taps), dbh (C a
    convolution block, column taps), dkh (row taps), and for half B
    [dmul; dadd] (2C a convolution block, row taps); in float32 the two
    input gradients' split tap matrices besides."""
    C = shape[-1]
    npix = shape[0] * shape[1] * shape[2]
    wg = (wgrad_rows(shape, 1, dtype) + wgrad_rows(shape, 0, dtype)) * 3 * C * C
    return (dyv_split(C, npix)[0] * C + wg + sum_rows(shape, 1, dtype) * C
            + (2 * C * sum_rows(shape, 0, dtype) if half_b else 0)
            + 2 * conv_space(C, dtype))


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
    # the blocks' partials (any contents); the fold writes the moments whole
    floats = fwd_partials(x.shape, x.dtype)
    part = torch.empty(floats, dtype=torch.float32, device=x.device)
    mom = torch.empty(2, C, dtype=torch.float32, device=x.device)
    launch(kernel("nb_half_fwd", symbol, "p" * 10 + "i" * 6 + "p"),
           x.device, x.data_ptr(), khb.data_ptr(), bhf.data_ptr(),
           kwb.data_ptr(), bwf.data_ptr(), _ptr(ma), ymid.data_ptr(),
           yout.data_ptr(), mom.data_ptr(), part.data_ptr(), B, H, W, C, d,
           floats)
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
    floats = bwd_partials(x.shape, ma is not None, x.dtype)
    part = torch.empty(floats, dtype=torch.float32, device=x.device)
    # one f32 buffer for every sum, written whole by the fold
    n_k = 3 * C * C
    acc = torch.empty(2 * n_k + 4 * C, dtype=torch.float32, device=x.device)
    dkh, dkw = acc[:n_k].view(3, C, C), acc[n_k:2 * n_k].view(3, C, C)
    dbh, dbw = acc[2 * n_k:2 * n_k + C], acc[2 * n_k + C:2 * n_k + 2 * C]
    dma = acc[2 * n_k + 2 * C:].view(2, C) if ma is not None else None
    launch(kernel("nb_half_bwd", symbol, "p" * 17 + "i" * 6 + "p"),
           x.device, x.data_ptr(), _ptr(ma), ymid.data_ptr(),
           yout.data_ptr(), dyout.data_ptr(), dmom.data_ptr(),
           khT.data_ptr(), kwT.data_ptr(), dyv.data_ptr(), dmid.data_ptr(),
           dx.data_ptr(), dkh.data_ptr(), dbh.data_ptr(), dkw.data_ptr(),
           dbw.data_ptr(), _ptr(dma), part.data_ptr(), B, H, W, C, d,
           floats)
    (nb_half_a if mul is None else nb_half_b).bwd_launches += 1
    if dma is None:
        return dx, None, None, dkh, dbh, dkw, dbw
    return dx, dma[0], dma[1], dkh, dbh, dkw, dbw


# the 3-tap tiles whose occupancy and blocks a launch `ld_nb_half_fwd_info`
# / `ld_nb_half_bwd_info` report, in their order: the bf16 tiles
# (csrc/conv3tap.cuh, csrc/wgrad3tap.cuh), then the float32 convolution
# tile (csrc/conv3tap_f32.cuh); and what each reports of one
TILE_KERNELS = {
    "nb_half_fwd": {"bfloat16": ("conv bias relu", "conv bias moments"),
                    "float32": ("conv bias relu", "conv bias moments")},
    "nb_half_bwd": {"bfloat16": ("conv relu mask", "conv plain",
                                 "conv prologue backward", "wgrad"),
                    "float32": ("conv relu mask", "conv plain",
                                "conv prologue backward")}}
TILE_INFO = ("registers", "local_bytes", "blocks_per_sm", "smem_bytes",
             "blocks")


def tile_info(shape, d: int, device) -> dict:
    """What the card makes of the 3-tap tiles on a (B, H, W, C) plane at
    dilation d: {dtype: {kernel: {registers, local_bytes, blocks_per_sm,
    smem_bytes, blocks}}} for each instantiation the half blocks launch,
    dtype "bfloat16" or "float32", `blocks` its blocks a launch (of the
    weight gradient, its larger axis's). Needs a card."""
    B, H, W, C = shape
    if C not in (16, 64, 128):
        raise ValueError(f"nb_half kernels: C={C} not in (16, 64, 128)")
    n = len(TILE_INFO)
    out = {"bfloat16": {}, "float32": {}}
    for lib, kernels in TILE_KERNELS.items():
        rows = [(dt, name) for dt, names in kernels.items() for name in names]
        info = (ctypes.c_int * (n * len(rows)))()
        fn = kernel(lib, f"ld_{lib}_info", "iiiiip")
        with torch.cuda.device(device):
            rc = fn(B, H, W, C, d, ctypes.addressof(info))
        if rc != 0:
            raise RuntimeError(f"ld_{lib}_info failed: CUDA error {rc}")
        for i, (dt, name) in enumerate(rows):
            out[dt][name] = dict(zip(TILE_INFO, info[n * i:n * i + n]))
    return out


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
