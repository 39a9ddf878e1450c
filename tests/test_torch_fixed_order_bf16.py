"""The fixed-order sums of the bf16 training tiles (K6 / K7 and K11 in
bf16) and of K11's bias gradient in both dtypes, on the CPU.

The bf16 3-tap tiles (`csrc/conv3tap.cuh`, `csrc/wgrad3tap.cuh`) are
persistent blocks that walk tiles of one image (`TileGeo`): the
convolution's warpgroup w of block b takes tiles b NWG + w + k NWG blocks,
the weight gradient's block b tiles b + k blocks (at C = 128 once for each
tap); each convolution block writes its sums to its row of a partials
buffer, each cluster of weight-gradient blocks its blocks' sums added on
chip, and `csrc/fold.cuh` adds the rows in the order
`ops/fold.py::fold_rows` writes. The block counts are constants of the
shape (`ops/nb_block.py`: `bf16_conv_rows`, `bf16_wgrad_grid`,
`bf16_wgrad_rows`), one wave of the H100. K11's bias
gradient (`csrc/packed_conv.cu::dz_kernel`) is a grid-stride walk as the
half blocks' dyv pass (`nb_block.dyv_split`), in both dtypes.

Here, in float64, the kernels' walks cover every tile and pixel once;
each sum is split the way its kernel splits it, the blocks' partials are
folded in that order, and the result equals the plain sum to 1e-12 of
max, at C = 16, 64 and 128 and d = 1 and 16. Then the bf16 wrappers with
`kernel`, `launch` and `check_cuda` stubbed ask for a partials scratch of
the counted floats and zero-fill nothing."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu_torch.ops import nb_block as nb
from lanedetection_end2end_tpu_torch.ops import packed_conv as pc
from lanedetection_end2end_tpu_torch.ops.fold import cdiv, fold_rows
from test_torch_fixed_order_sums import (  # noqa: F401 (the fixture)
    _asked, _close, _conv3, _rn, _t, half_sums_plain, stride_rows, stubs)
from test_torch_threads import one_torch_thread  # noqa: F401

F32, BF16 = torch.float32, torch.bfloat16
CSRC = Path(nb.__file__).resolve().parents[1] / "csrc"


# ----------------------------------------------------------------------
# The bf16 tiles' walks (TileGeo) and the blocks they give each pixel
# ----------------------------------------------------------------------

def tile_of(shape, axis: int, bm: int) -> torch.Tensor:
    """(npix,) the tile of each pixel: tiles of one image, 8 rows x bm / 8
    columns (axis 0) or bm columns of a row (axis 1), numbered by image,
    block of rows, block of columns (`TileGeo::at`)."""
    B, H, W, _ = shape
    th = 8 if axis == 0 else 1
    tw = bm // th
    b, h, w = torch.meshgrid(torch.arange(B), torch.arange(H),
                             torch.arange(W), indexing="ij")
    return ((b * cdiv(H, th) + h // th) * cdiv(W, tw) + w // tw).reshape(-1)


def conv_blocks(shape, axis: int):
    """(the block of each pixel, blocks) of the bf16 convolution."""
    nwg, bm = nb.BF16_CONV[shape[-1]]
    rows = nb.bf16_conv_rows(shape, axis)
    return tile_of(shape, axis, bm) % (rows * nwg) // nwg, rows


def wgrad_blocks(shape, axis: int):
    """(the row of each pixel, rows) of the bf16 weight gradient (a tap at
    C = 128): its block's cluster."""
    grid, k = nb.bf16_wgrad_grid(shape, axis), nb.BF16_WG_CLUSTER[shape[-1]]
    return tile_of(shape, axis, nb.BF16_WG_BM) % grid // k, grid // k


def walk(ntiles: int, slots: int):
    """The tiles each walker takes in the kernels' order: walker g tiles
    g, g + slots, ..."""
    return [list(range(g, ntiles, slots)) for g in range(slots)]


def tile_pixels(shape, axis: int, bm: int, tile: int):
    """The pixels of `tile` that lie on the plane (`TileGeo::tile_pixel`
    over the tile's rows and columns)."""
    B, H, W, _ = shape
    th = 8 if axis == 0 else 1
    tw = bm // th
    fcb, frb = cdiv(W, tw), cdiv(H, th)
    q, cb = divmod(tile, fcb)
    b, rb = divmod(q, frb)
    return [(b * H + rb * th + r) * W + cb * tw + c
            for r in range(th) for c in range(tw)
            if rb * th + r < H and cb * tw + c < W]


# ----------------------------------------------------------------------
# The walks cover the plane, with counts fixed by the shape
# ----------------------------------------------------------------------

# planes of several waves of tiles and partial tiles at the edges, and the
# 256x512 step's planes at batch 8
PLANES = [(2, 136, 200, 16), (2, 96, 136, 64), (2, 72, 80, 128),
          (1, 8, 16, 128), (8, 128, 256, 16), (8, 64, 128, 64),
          (8, 32, 64, 128)]


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", PLANES, ids=str)
def test_bf16_walks_cover_every_pixel_once(shape, axis):
    """Each tile goes to one walker of the convolution and one block of the
    weight gradient, each pixel lies in one tile, and the map pixel ->
    row the sums tests use is the walk's (NWG walkers a convolution row,
    a cluster of blocks a weight-gradient row)."""
    B, H, W, C = shape
    npix = B * H * W
    for bm, slots, blocks_of in (
            (nb.BF16_CONV[C][1], nb.bf16_conv_rows(shape, axis)
             * nb.BF16_CONV[C][0], conv_blocks),
            (nb.BF16_WG_BM, nb.bf16_wgrad_grid(shape, axis), wgrad_blocks)):
        ntiles = nb.bf16_tiles(shape, axis, bm)
        tiles = walk(ntiles, slots)
        assert sorted(t for ts in tiles for t in ts) == list(range(ntiles))
        owner = torch.full((npix,), -1)
        group = slots // blocks_of(shape, axis)[1]  # walkers a row
        for g, ts in enumerate(tiles):
            for t in ts:
                px = torch.tensor(tile_pixels(shape, axis, bm, t))
                assert (owner[px] == -1).all()
                owner[px] = g // group
        assert (owner >= 0).all()
        assert torch.equal(owner, blocks_of(shape, axis)[0])


def test_bf16_counts_are_the_kernels_constants():
    """The row counts depend on the shape alone, and the constants they
    come from are those of the CUDA tiles: one wave of the H100's 132 SMs,
    the convolution at one block an SM (4 warpgroups of 128-pixel tiles at
    C = 16, of 64-pixel tiles at 64; 2 at 128), the weight gradient at two
    (264 blocks; 44 a tap at C = 128), in clusters of two at C = 64."""
    conv = (CSRC / "conv3tap.cuh").read_text()
    wgrad = (CSRC / "wgrad3tap.cuh").read_text()
    assert f"static constexpr int WAVE = {nb.BF16_WAVE};" in conv
    assert "static constexpr int NWG = C == 128 ? 2 : 4;" in conv
    assert "static constexpr int MT = C == 16 ? 2 : 1;" in conv
    assert {C: (2 if C == 128 else 4, 128 if C == 16 else 64)
            for C in (16, 64, 128)} == nb.BF16_CONV
    m = re.search(r"BLOCKS = C == 128 \? (\d+) : (\d+);", wgrad)
    assert (int(m[1]), int(m[2])) == (nb.BF16_WG_BLOCKS[128],
                                      nb.BF16_WG_BLOCKS[64])
    assert nb.BF16_WG_BLOCKS[16] == nb.BF16_WG_BLOCKS[64]
    assert "static constexpr int CLUSTER = C == 64 ? 2 : 1;" in wgrad
    assert nb.BF16_WG_CLUSTER == {16: 1, 64: 2, 128: 1}
    # a plane of fewer tiles than a cluster still takes one
    assert nb.bf16_wgrad_grid((1, 8, 8, 64), 0) == 2
    # at the 256x512 step's planes
    assert [nb.bf16_conv_rows(s, a) for s in PLANES[4:] for a in (0, 1)] == [
        132, 132, 132, 132, 128, 128]
    assert [nb.bf16_wgrad_rows(s, a) for s in PLANES[4:] for a in (0, 1)] == [
        264, 264, 132, 132, 44, 44]


# ----------------------------------------------------------------------
# The sums, split and folded as the kernels do
# ----------------------------------------------------------------------

def block_rows(values, blocks_of, rows: int):
    """(npix, ...) per-pixel values -> (rows, ...): row b sums block b's
    pixels."""
    out = torch.zeros(rows, *values.shape[1:], dtype=values.dtype)
    return out.index_add_(0, blocks_of, values)


def conv_sum(t, axis: int):
    """A convolution epilogue's per-channel sum of t over the bf16 tile's
    blocks, folded in order."""
    blocks_of, rows = conv_blocks(t.shape, axis)
    return fold_rows(block_rows(t.reshape(-1, t.shape[-1]), blocks_of, rows))


def wgrad_sum(a, dy, axis: int, d: int):
    """sum_t shift_t(a)^T dy over the bf16 weight gradient's clusters (each
    tap's rows at its place in the row), folded in order."""
    C = a.shape[-1]
    blocks_of, rows = wgrad_blocks(a.shape, axis)
    dyf = dy.reshape(-1, C)
    taps = [nb._shift(a, (t - 1) * d, 1 + axis).reshape(-1, C)
            for t in range(3)]
    part = torch.zeros(rows, 3, C, C, dtype=a.dtype)
    for b in range(rows):
        sel = blocks_of == b
        for t in range(3):
            part[b, t] = taps[t][sel].T @ dyf[sel]
    return fold_rows(part)


def dz_sum(t):
    """K11's dz pass (and the half blocks' dyv pass): a grid-stride walk,
    folded in order."""
    C = t.shape[-1]
    blocks, rpi = nb.dyv_split(C, t.numel() // C)
    return fold_rows(stride_rows(t.reshape(-1, C), rpi, blocks))


def half_sums_bf16(x, mul, add, ymid, yout, dyout, dmom, kh, kw, d):
    """The sums of the bf16 half blocks, forward and backward, each in its
    kernels' partition and fold order (float64) -> {name: tensor}."""
    out = {"mom": torch.stack([conv_sum(yout, 1), conv_sum(yout * yout, 1)])}
    z = x if mul is None else torch.relu(x * mul + add)
    dyv = dyout + dmom[0] + 2.0 * yout * dmom[1]
    out["dbw"] = dz_sum(dyv)
    out["dkw"] = wgrad_sum(ymid, dyv, 1, d)
    dmid = _conv3(dyv, nb._transposed_taps(kw), 1, d) * (ymid > 0)
    out["dbh"] = conv_sum(dmid, 1)
    out["dkh"] = wgrad_sum(z, dmid, 0, d)
    if mul is not None:
        dz = _conv3(dmid, nb._transposed_taps(kh), 0, d) * (x * mul + add > 0)
        out["dmul"], out["dadd"] = conv_sum(dz * x, 0), conv_sum(dz, 0)
    return out


# (half, plane, d): each channel count at d = 1 and 16, on planes where
# the walks wrap (more tiles than walkers) and edge tiles are partial
HALVES = {"a C=16 d=1": ("a", (2, 136, 200, 16), 1),
          "b C=16 d=16": ("b", (2, 136, 200, 16), 16),
          "b C=64 d=1": ("b", (2, 96, 136, 64), 1),
          "a C=64 d=16": ("a", (2, 96, 136, 64), 16),
          "a C=128 d=1": ("a", (2, 72, 80, 128), 1),
          "b C=128 d=16": ("b", (2, 72, 80, 128), 16)}


@pytest.mark.parametrize("case", sorted(HALVES))
def test_bf16_half_block_sums_fold_to_the_plain_sums(case):
    half, shape, d = HALVES[case]
    C = shape[-1]
    rng = np.random.default_rng(sum(map(ord, case)))
    x, ymid, yout, dyout = (_rn(rng, *shape) for _ in range(4))
    ymid = torch.relu(ymid)
    kh, kw = _rn(rng, 3, C, C), _rn(rng, 3, C, C)
    dmom = 1e-2 * _rn(rng, 2, C)
    mul = add = None
    if half == "b":
        mul, add = _rn(rng, C).abs() + 0.5, _rn(rng, C)
    args = (x, mul, add, ymid, yout, dyout, dmom, kh, kw, d)
    got, want = half_sums_bf16(*args), half_sums_plain(*args)
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name])


# (plane, d, axis) of K11: each channel count, both axes, d = 1 and 16
K11 = {"C=16 d=1 h": ((2, 136, 200, 16), 1, "h"),
       "C=64 d=16 w": ((2, 96, 136, 64), 16, "w"),
       "C=128 d=16 h": ((2, 72, 80, 128), 16, "h"),
       "C=128 d=1 w": ((2, 72, 80, 128), 1, "w")}


@pytest.mark.parametrize("dt", [F32, BF16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(K11))
def test_k11_sums_fold_to_the_plain_sums(case, dt):
    """db over the dz pass's blocks in both dtypes; dk over the bf16 weight
    gradient's blocks (the float32 one's: tests/test_torch_fixed_order_sums
    .py, the half blocks' tile)."""
    shape, d, axis = K11[case]
    C = shape[-1]
    rng = np.random.default_rng(sum(map(ord, case)))
    x, y, dy = (_rn(rng, *shape) for _ in range(3))
    dz = dy * (y > 0) if axis == "h" else dy  # relu on the 3x1 ones
    _close(dz_sum(dz), dz.sum(nb._SUM))
    if dt == BF16:
        _close(wgrad_sum(x, dz, pc.AXES[axis], d),
               nb._wgrad3(x, dz, pc.AXES[axis], d))
    assert pc.bwd_partials(shape, axis, dt) == (
        nb.dyv_split(C, x.numel() // C)[0] * C
        + nb.wgrad_rows(shape, pc.AXES[axis], dt) * 3 * C * C)


# ----------------------------------------------------------------------
# The bf16 wrappers: a partials scratch, no zero fill
# ----------------------------------------------------------------------

@pytest.mark.parametrize("C", [16, 64, 128])
def test_bf16_half_block_partials_count_the_tiles_rows(stubs, C):
    """The bf16 half blocks' partials at each C: the counted rows of each
    launch, and no zero fill."""
    B, H, W, d = 2, 24, 40, 2
    x = _t(B, H, W, C, dtype=BF16)
    k, b = _t(3, C, C), _t(C)
    shape = x.shape
    fwd = 2 * C * nb.bf16_conv_rows(shape, 1)
    nb._half_fwd_cuda(x, b, b, k, b, k, b, d)
    _asked(stubs, 9, fwd)
    stubs.calls.clear()
    nb.half_bwd_kernel(x, b, b, x, x, x, _t(2, C), k, k, d)
    _asked(stubs, 16, nb.dyv_split(C, B * H * W)[0] * C
           + (nb.bf16_wgrad_rows(shape, 0) + nb.bf16_wgrad_rows(shape, 1))
           * 3 * C * C + nb.bf16_conv_rows(shape, 1) * C
           + nb.bf16_conv_rows(shape, 0) * 2 * C)
    assert stubs.zeroed == []


@pytest.mark.parametrize("act,bias,axis", [(True, True, "h"),
                                           (False, True, "w"),
                                           (False, False, "w")])
def test_k11_bf16_asks_for_partials(stubs, act, bias, axis):
    """K11 in bf16: dk and db (with a bias) from the fold, no zero fill."""
    B, H, W, C = 2, 8, 8, 64
    x, k = _t(B, H, W, C, dtype=BF16), _t(3, C, C)
    pc.packed_conv_bwd_kernel(x, x if act else None, x, k, axis, 1, act,
                              bias=bias)
    db = nb.dyv_split(C, B * H * W)[0] * C if bias else 0
    _asked(stubs, 8, db + nb.bf16_wgrad_rows(x.shape, pc.AXES[axis])
           * 3 * C * C)
    assert stubs.zeroed == []
