"""The float32 3-tap convolution tile (`csrc/conv3tap_f32.cuh`: K6 / K7's
convolutions and input gradients and K11's in float32) in plain PyTorch on
the CPU: its weight split, its index plan and its partition, checked
where no card is needed.

The tile splits the tap matrices once a launch (`wsplit_f32_kernel`) into
TF32 hi and lo planes in wgmma's K-major core-matrix order, mirrored by
`ops/tf32x3.py::split_planes`: hi and lo are `split_tf32`'s, each tap
value lands once, and the descriptor's offsets (128 bytes a 4-deep k step,
KC / 4 * 128 a block of 8 n) address them. Its persistent blocks walk
groups of NWG tiles of conv3tap.cuh's `TileGeo` (mirrored by the bf16
tests' `Geo`) in step, K in chunks of KC input channels of all three taps,
each tile's pixels staged once for the three taps (one run of the tile
and d more rows or columns on each side, else three bands), zero where a
staged pixel falls off the plane, the prologue only on the pixels on it.
Through that plan a float64 convolution equals `ops/tf32x3.py::_conv3_f64`
to 1e-12 at C 16 / 64 / 128, d 1 / 2 / 16 / 80, both axes, tiles partial
at both edges, with the half-B prologue and at d >= H; every tile is
visited once. The walk gives each pixel to one block, the block count
(`ops/nb_block.py::conv_rows`) depends on the shape alone and is one wave
at most, and the wrappers' scratch counts hold the split planes beside
the sums' rows. The Python constants mirror the header's, which the test
reads.
"""


import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu_torch.ops import nb_block as nb
from lanedetection_end2end_tpu_torch.ops import packed_conv as pc
from lanedetection_end2end_tpu_torch.ops.tf32x3 import (
    _conv3_f64, core_nk, split_planes, split_tf32)
from test_torch_conv3tap_bf16 import (
    CSRC, PLANES, SMEM_BLOCK, TOL, Geo, _Fn, _Null, _plane, _rel, prologue)
from test_torch_fixed_order_bf16 import tile_pixels, walk
from test_torch_fixed_order_sums import (  # noqa: F401 (the fixture)
    _asked, _t, f32_conv_blocks, stubs)
from test_torch_threads import one_torch_thread  # noqa: F401

F32, BF16 = torch.float32, torch.bfloat16


class F32Tile:
    """`ConvTile<C>` of conv3tap_f32.cuh."""

    def __init__(self, C):
        self.NWG = 4 if C == 16 else 2
        self.MT = 2 if C == 64 else 1
        self.BM = 64 * self.MT
        self.KC = 16 if C == 16 else 8     # channels a product
        self.KCS = 32 if C == 128 else 16  # channels a stage
        self.U = self.KCS // self.KC
        self.CPT = C // self.KCS
        self.LDA = self.KCS + 4
        self.ROWS = 3 * self.BM
        self.B_CHUNK = 6 * self.KC * C
        self.PLANES = 6 * C * C
        self.RESIDENT = C <= 64
        self.B_STAGES = 4
        self.MAX_STAGES = 8
        self.BARS = 128
        self.W_BYTES = 4 * (self.PLANES if self.RESIDENT
                            else self.B_STAGES * self.B_CHUNK)
        self.SMEM = 232448
        self.RING = (self.SMEM - self.BARS - self.W_BYTES) // self.NWG
        self.RING = self.RING // 128 * 128  # a warpgroup's

    def stage_floats(self, nload):
        return (nload * self.LDA + 31) & ~31

    def stages(self, nload):
        return min(self.MAX_STAGES,
                   self.RING // (self.stage_floats(nload) * 4))


def test_the_mirror_holds_the_headers_constants():
    src = (CSRC / "conv3tap_f32.cuh").read_text()
    for line in (
            "static constexpr int WAVE = 132;",
            "static constexpr int NWG = C == 16 ? 4 : 2;",
            "static constexpr int THREADS = NWG * 128;",
            "static constexpr int MT = C == 64 ? 2 : 1;",
            "static constexpr int BM = 64 * MT;",
            "static constexpr int KC = C == 16 ? 16 : 8;",
            "static constexpr int KCS = C == 128 ? 32 : 16;",
            "static constexpr int U = KCS / KC;",
            "static constexpr int CPT = C / KCS;",
            "static constexpr int LDA = KCS + 4;",
            "static constexpr int ROWS = 3 * BM;",
            "static constexpr int B_CHUNK = 6 * KC * C;",
            "static constexpr int PLANES = 6 * C * C;",
            "static constexpr bool RESIDENT = C <= 64;",
            "static constexpr int B_STAGES = 4;",
            "static constexpr int MAX_STAGES = 8;",
            "static constexpr int BARS = 128;",
            "static constexpr int W_BYTES = (RESIDENT ? PLANES : B_STAGES * B_CHUNK) * 4;",
            "static constexpr int SMEM = 232448;",
            "static constexpr int RING = (SMEM - BARS - W_BYTES) / NWG / 128 * 128;",
            "return (nload * LDA + 31) & ~31;",
            "const int nst = min(T::MAX_STAGES, T::RING / (stage_floats * 4));",
            "const int tile = (b + i / T::CPT * blocks) * T::NWG + wg;",
            "return groups < T::WAVE ? groups : T::WAVE;"):
        assert line in src, line
    assert {C: (F32Tile(C).NWG, F32Tile(C).BM)
            for C in (16, 64, 128)} == nb.F32_CONV
    assert {C: F32Tile(C).KC for C in (16, 64, 128)} == nb.F32_KC
    assert all(nb.f32_planes(C) == F32Tile(C).PLANES for C in (16, 64, 128))


@pytest.mark.parametrize("C", [16, 64, 128])
def test_every_plan_fits_three_stages_and_the_sums(C):
    """Whatever the staged rows (a run of the tile and 2d for d = 1 .. BM,
    or three bands), a warpgroup's ring holds 2 .. 8 stages, so the wait
    depth nst - 2 is one the tile spells out (0 .. 6), and three or more
    where the tile's run is short (d <= 4 on the row taps, d <= 16 on the
    column taps); the block's shared memory is the card's most, and the
    warps' rows of sums fit where the planes were."""
    T = F32Tile(C)
    assert T.SMEM <= SMEM_BLOCK
    assert T.BARS + T.W_BYTES + T.NWG * T.RING <= T.SMEM
    assert T.W_BYTES % 128 == 0 and 8 * (1 + 2 * T.B_STAGES) <= T.BARS
    geo_rows = [T.BM + 2 * d for d in range(1, T.BM + 1)] + [T.ROWS]
    for nload in geo_rows:
        assert 2 <= T.stages(nload) <= T.MAX_STAGES
        assert T.stages(nload) * T.stage_floats(nload) * 4 <= T.RING
    assert T.NWG * 4 * 2 * C * 4 <= T.W_BYTES
    assert T.stages(T.BM + 2) >= T.stages(T.ROWS)
    tw = T.BM // 8
    assert T.stages((8 + 2 * 4) * tw) >= 3 and T.stages(T.BM + 32) >= 3


# ----------------------------------------------------------------------
# The weight split: TF32 halves in wgmma's core-matrix order
# ----------------------------------------------------------------------

@pytest.mark.parametrize("C", [16, 64, 128])
def test_the_weight_split_gives_the_tf32_halves_in_core_order(C):
    """Plane h of tap t in chunk cc holds split_tf32(w)[h][t][cc KC + k][n]
    at float core_nk^-1(n, k), each tap value once in each plane, and the
    B descriptor's offsets of an 8-deep step s (128 bytes a 4 k, KC / 4 *
    128 bytes an 8 n) reach exactly those floats."""
    kc = nb.F32_KC[C]
    g = torch.Generator().manual_seed(C)
    w = torch.randn(3, C, C, generator=g) * 10.0 ** torch.randint(
        -6, 6, (3, C, C), generator=g)
    planes = split_planes(w, kc).view(C // kc, 3, 2, kc * C)
    hi, lo = split_tf32(w)
    assert torch.equal(hi + lo, hi.double().add(lo.double()).float())
    n, k = core_nk(torch.arange(kc * C), kc)
    seen = torch.zeros(C, kc, dtype=torch.int64)
    seen.index_put_((n, k), torch.ones(kc * C, dtype=torch.int64),
                    accumulate=True)
    assert (seen == 1).all()  # a permutation of the kc x C slice
    for cc in range(C // kc):
        for t in range(3):
            for h, want in enumerate((hi, lo)):
                slab = want[t, cc * kc:(cc + 1) * kc]  # (k, n)
                assert torch.equal(planes[cc, t, h], slab[k, n])
    # the descriptor's address of element (n, k = 8 s + kk) of step s
    nn, kk = np.meshgrid(np.arange(C), np.arange(8), indexing="ij")
    for s in range(kc // 8):
        addr = (s * 64 + (kk // 4) * 32 + (nn // 8) * (kc // 4) * 32
                + (nn % 8) * 4 + kk % 4)
        e = torch.from_numpy(addr.reshape(-1))
        n_, k_ = core_nk(e, kc)
        assert torch.equal(n_, torch.from_numpy(nn.reshape(-1)))
        assert torch.equal(k_, torch.from_numpy((8 * s + kk).reshape(-1)))


def test_the_split_is_the_cvt_rna_split():
    """hi is w rounded to TF32 to nearest, ties away (cvt.rna), and lo the
    TF32 rounding of the exact remainder: ties planted in both."""
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11),
                        1.0 + 2.0 ** -11 + 2.0 ** -23])
    w = torch.zeros(3, 16, 16)
    w[0, 0, :3] = tie
    planes = split_planes(w, 16).view(1, 3, 2, 16 * 16)
    n, k = core_nk(torch.arange(16 * 16), 16)
    at = [int(((n == c) & (k == 0)).nonzero()) for c in range(3)]
    assert planes[0, 0, 0, at].tolist() == [1.0 + 2.0 ** -10,
                                            -(1.0 + 2 * 2.0 ** -10),
                                            1.0 + 2.0 ** -10]
    # the third remainder, -2^-11 + 2^-23, needs 12 mantissa bits: TF32
    # rounds it to -2^-11
    assert planes[0, 0, 1, at].tolist() == [-2.0 ** -11, 2.0 ** -11,
                                            -2.0 ** -11]


# ----------------------------------------------------------------------
# The plan: persistent groups of tiles, one staging for three taps
# ----------------------------------------------------------------------

def conv_through_plan(x, w, d, axis, mul=None, add=None, mask=True):
    """conv3tap_f32_kernel's plan in float64 over its launch's blocks
    (`nb.conv_rows`), KCS staged channels a stage, U products of KC of them
    -> (out (B, H, W, co), visits a tile, the block of each pixel's
    output). `mask=False` applies the prologue to the zero-filled pixels
    too (the control)."""
    B, H, W, C = x.shape
    T = F32Tile(C)
    geo = Geo(T.BM, H, W, d, axis)
    npix = B * H * W
    X = x.reshape(npix, C)
    ntiles = geo.ntiles(B)
    groups = -(-ntiles // T.NWG)
    grid = nb.conv_rows(x.shape, axis)
    nload = geo.nload()
    out = torch.zeros(npix, C, dtype=torch.float64)
    block_of = torch.full((npix,), -1)
    visits = np.zeros(ntiles, np.int64)
    for b in range(grid):
        n = ((groups - 1 - b) // grid + 1 if b < groups else 0) * T.CPT
        acc = [None] * T.NWG
        for i in range(n):
            cc = i % T.CPT
            ch = cc * T.KCS
            for wg in range(T.NWG):
                tile = (b + i // T.CPT * grid) * T.NWG + wg
                if tile >= ntiles:
                    continue
                R0, h0, c0 = geo.at(tile)
                q = geo.staged_pixel(R0, h0, c0, np.arange(nload))
                ok = torch.from_numpy(q >= 0)
                stage = torch.zeros(nload, T.KCS, dtype=torch.float64)
                stage[ok] = X[torch.from_numpy(q[q >= 0]), ch:ch + T.KCS]
                if mul is not None:
                    rows = ok if mask else slice(None)
                    stage[rows] = prologue(stage[rows], mul[ch:ch + T.KCS],
                                           add[ch:ch + T.KCS])
                if cc == 0:
                    visits[tile] += 1
                    acc[wg] = torch.zeros(T.BM, C, dtype=torch.float64)
                for u in range(T.U):
                    k0 = u * T.KC
                    for t in range(3):
                        base = geo.base(t)
                        assert base + T.BM <= nload
                        acc[wg] += (stage[base:base + T.BM, k0:k0 + T.KC]
                                    @ w[t, ch + k0:ch + k0 + T.KC])
                if cc == T.CPT - 1:
                    p = geo.band_pixel(R0, h0, c0, 1, np.arange(T.BM))
                    keep = p >= 0
                    pix = torch.from_numpy(p[keep])
                    out[pix] = acc[wg][torch.from_numpy(keep)]
                    block_of[pix] = b
    return out.reshape(B, H, W, C), visits, block_of


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("d", [1, 2, 16, 80])
@pytest.mark.parametrize("C", [16, 64, 128])
def test_convolution_through_the_plan(C, d, axis, plane):
    x, w, _ = _plane(plane + (C,), 5 * C + d + axis)
    got, visits, block_of = conv_through_plan(x, w, d, axis)
    assert (visits == 1).all()
    assert _rel(got, _conv3_f64(x, w, axis, d)) < TOL
    assert torch.equal(block_of, f32_conv_blocks(x.shape, axis))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("d", [1, 16])
@pytest.mark.parametrize("C", [16, 64, 128])
def test_the_prologue_keeps_the_padding_zero(C, d, axis):
    """Half B's first convolution with add > 0, so relu(add) > 0 where the
    tap falls off: the plan's z is zero there; with the prologue on the
    zero-filled rows too (the control) the plan reads far off."""
    x, w, g = _plane(PLANES[0] + (C,), 11 * C + d + axis)
    mul = 0.5 + torch.rand(C, generator=g, dtype=torch.float64)
    add = 0.2 + torch.rand(C, generator=g, dtype=torch.float64)
    want = _conv3_f64(prologue(x, mul, add), w, axis, d)
    got, _, _ = conv_through_plan(x, w, d, axis, mul, add)
    assert _rel(got, want) < TOL
    ctl, _, _ = conv_through_plan(x, w, d, axis, mul, add, mask=False)
    assert _rel(ctl, want) > 1e-2


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("C", [16, 64, 128])
def test_the_d_beyond_the_plane_edge(C, axis):
    """The resize-64 NB1D-128 plane (8x16) with d = 16 >= H, W: the shifted
    taps read only zeros, with and without the prologue."""
    x, w, g = _plane((2, 8, 16, C), 13 * C + axis)
    mul = 0.5 + torch.rand(C, generator=g, dtype=torch.float64)
    add = 0.2 + torch.rand(C, generator=g, dtype=torch.float64)
    for m, a in ((None, None), (mul, add)):
        z = x if m is None else prologue(x, m, a)
        got, visits, _ = conv_through_plan(x, w, 16, axis, m, a)
        assert (visits == 1).all()
        assert _rel(got, (z @ w[1]).reshape(got.shape)) < TOL


# ----------------------------------------------------------------------
# The partition: shape alone, every pixel once, one wave at most
# ----------------------------------------------------------------------

# the 256x512 step's planes at batch 8, its C = 128 plane at batch 128
# (each warpgroup walks 15 or 16 tiles), and planes of partial tiles at
# the edges
WALK_PLANES = [(8, 128, 256, 16), (8, 64, 128, 64), (8, 32, 64, 128),
               (128, 32, 64, 128), (2, 136, 200, 16), (2, 96, 136, 64),
               (2, 72, 80, 128), (1, 8, 16, 128), (3, 13, 21, 64)]


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", WALK_PLANES, ids=str)
def test_the_walk_covers_every_pixel_once(shape, axis):
    """Walker (b, w) takes tiles b NWG + w + k NWG blocks: each tile goes
    to one warpgroup of one block, each pixel lies in one tile, and the
    pixel -> block map is the one the sums tests fold by."""
    B, H, W, C = shape
    nwg, bm = nb.F32_CONV[C]
    grid = nb.conv_rows(shape, axis)
    ntiles = nb.bf16_tiles(shape, axis, bm)
    assert grid == min(-(-ntiles // nwg), 132)
    tiles = walk(ntiles, grid * nwg)
    assert sorted(t for ts in tiles for t in ts) == list(range(ntiles))
    owner = torch.full((B * H * W,), -1)
    for gw, ts in enumerate(tiles):
        for t in ts:
            px = torch.tensor(tile_pixels(shape, axis, bm, t))
            assert (owner[px] == -1).all()
            owner[px] = gw // nwg
    assert (owner >= 0).all()
    assert torch.equal(owner, f32_conv_blocks(shape, axis))


def test_the_block_counts_depend_on_the_shape_alone():
    """The step's planes at batch 128 and 8 fill one wave; the counts are
    functions of the shape and axis (not of d, the dtype's values or the
    card)."""
    for C, hw in ((16, (128, 256)), (64, (64, 128)), (128, (32, 64))):
        for batch in (8, 128):
            rows = [nb.conv_rows((batch,) + hw + (C,), a) for a in (0, 1)]
            assert rows[0] == rows[1] <= 132
            assert nb.sum_rows((batch,) + hw + (C,), 1, F32) == rows[1]
    assert nb.conv_rows((8, 32, 64, 128), 0) == 128
    assert nb.conv_rows((128, 32, 64, 128), 0) == 132


# ----------------------------------------------------------------------
# The wrappers' scratch: the sums' rows and the split planes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("C", [16, 64, 128])
def test_the_partials_hold_the_planes_beside_the_rows(C):
    """Each float32 convolution takes 6 C^2 floats of its entry point's
    scratch for the split taps; bf16 takes none."""
    shape = (2, 24, 40, C)
    rows1, rows0 = nb.conv_rows(shape, 1), nb.conv_rows(shape, 0)
    assert nb.fwd_partials(shape, F32) == 2 * C * rows1 + 2 * 6 * C * C
    assert nb.fwd_partials(shape, BF16) == 2 * C * nb.bf16_conv_rows(shape, 1)
    base = nb.bwd_partials(shape, True, BF16)
    npix = 2 * 24 * 40
    assert nb.bwd_partials(shape, True, F32) == (
        nb.dyv_split(C, npix)[0] * C
        + (nb.wgrad_rows(shape, 1, F32) + nb.wgrad_rows(shape, 0, F32))
        * 3 * C * C + rows1 * C + 2 * C * rows0 + 2 * 6 * C * C)
    assert base == nb.bwd_partials(shape, True, BF16)  # bf16 unchanged
    assert pc.fwd_partials(shape, F32) == 6 * C * C
    assert pc.fwd_partials(shape, BF16) == 0


@pytest.mark.parametrize("act,bias", [(True, True), (False, True),
                                      (False, False)])
def test_k11_forward_asks_for_the_planes_in_float32(stubs, act, bias):
    """K11's forward hands the float32 tile a scratch of the split taps'
    floats, and passes none in bf16."""
    B, H, W, C = 2, 8, 8, 64
    k = _t(3, C, C)
    b = _t(C) if bias else None
    pc._fwd_cuda(_t(B, H, W, C), k, b, "h", 1, act)
    _asked(stubs, 12, nb.f32_planes(C))
    stubs.calls.clear()
    pc._fwd_cuda(_t(B, H, W, C, dtype=BF16), k, b, "w", 1, act)
    [(_, _, args)] = stubs.calls
    assert args[12] is None and args[-1] == 0


def test_tile_info_reports_the_float32_tile(monkeypatch):
    """`ops/nb_block.py::tile_info` reads the float32 convolutions after
    the bf16 tiles in each library's entry, five ints each with the
    blocks a launch, on the plane and d it is given."""
    fns = {"nb_half_fwd": _Fn([100, 101, 110, 111]),
           "nb_half_bwd": _Fn([200, 201, 202, 203, 210, 211, 212])}
    monkeypatch.setattr(nb, "kernel", lambda lib, symbol, sig: fns[lib])
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    info = nb.tile_info((128, 32, 64, 128), 2, "cuda")
    assert fns["nb_half_bwd"].calls == [(128, 32, 64, 128, 2)]
    assert list(info["float32"]) == [
        *nb.TILE_KERNELS["nb_half_fwd"]["float32"],
        *nb.TILE_KERNELS["nb_half_bwd"]["float32"]]
    assert "wgrad" not in info["float32"]
    assert info["float32"]["conv bias moments"]["registers"] == 111
    assert info["float32"]["conv prologue backward"] == {
        "registers": 212, "local_bytes": 0, "blocks_per_sm": 1,
        "smem_bytes": 1006, "blocks": 106}
