"""The bf16 3-tap tiles (`csrc/conv3tap.cuh`, `csrc/wgrad3tap.cuh`: K6 / K7
and K11 in bf16) in plain PyTorch on the CPU: their index plan, checked
where no card is needed.

Both tiles walk tiles of conv3tap.cuh's TileGeo (mirrored by `Geo`): BM
pixels of one image, 8 rows x BM / 8 columns for the row taps, BM columns
of one row for the column taps, partial at the plane's edges. A chunk
stages the tile's pixels and d more rows or columns on each side (one
run, tap t a view of it from staged row base(t) on; for larger d three
bands, the tile shifted by each tap), zero where a staged pixel falls off
the plane, the prologue only on the pixels that lie on it, so that the
padding stays zero where relu(add) > 0. The convolution: persistent
warpgroups each walk tiles of their own in chunks of KC input channels.
The weight gradient: persistent blocks walk all tiles, summing all three
taps from one staged run (C = 16, 64) or one tap a block (C = 128).
Through those plans a float64 convolution equals
`ops/tf32x3.py::_conv3_f64` (`ops/nb1d.py::_conv3` in float64; `_conv3`
itself computes in float32) and the weight gradient
`ops/nb_block.py::_wgrad3` to 1e-12, at C 16 / 64 / 128, d 1 / 2 / 16 /
80, both axes, tiles partial at both edges, the half-B prologue with a
positive shift, and the d >= H edge (8x16, d = 16); every tile is visited
once (by every tap); every tile's shared memory fits the card; FastDiv is
exact. The operand layouts: the copies fill the column planes that wgmma
reads from any staged row (K-major for the convolution's A, MN-major for
the weight gradient's operands) and the tap matrices' MN-major core
matrices (the transposed-B form), each element once, and at C = 16 the
weight gradient's ldmatrix rows (mma.sync). The Python
constants mirror the header's, which the test reads.
"""

import ctypes
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu_torch.ops import nb_block as nb
from lanedetection_end2end_tpu_torch.ops.nb_block import _wgrad3
from lanedetection_end2end_tpu_torch.ops.tf32x3 import _conv3_f64
from test_torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(nb.__file__).resolve().parent.parent / "csrc"
THREADS = 256
SMEM_BLOCK = 232448  # shared memory a block may use on the H100
SMEM_SM = 233472     # an SM's, 1 KB of it reserved for each block
TOL = 1e-12


class ConvTile:
    """`ConvTile<C>` of conv3tap.cuh."""

    def __init__(self, C):
        self.NWG = 2 if C == 128 else 4
        self.MT = 2 if C == 16 else 1
        self.BM = 64 * self.MT
        self.TH = 8
        self.KC = 16 if C == 16 else 32
        self.CPT = C // self.KC
        self.PLANES = self.KC // 8
        self.ROWS = 3 * self.BM
        self.RING = 3 * self.ROWS * self.KC
        self.MAX_STAGES = 8
        self.OUT = self.BM * (C + 8)
        self.SMEM = (3 * C * C + self.NWG * (self.RING + self.OUT)) * 2 + (
            2 * C * 4)
        self.MIN_BLOCKS = 1

    def stages(self, nload):
        """A warpgroup's ring stages for a plan of `nload` staged rows."""
        return min(self.MAX_STAGES, self.RING // (nload * self.KC))


class WgradTile:
    """`WgradTile<C>` of wgrad3tap.cuh."""

    def __init__(self, C):
        self.BM, self.STAGES = 64, 3
        self.TAPS = 1 if C == 128 else 3
        self.MIN_BLOCKS = 2
        self.WS = 4 if C == 16 else 1  # mma.sync: a warp's partial dk
        rows = 3 * self.BM if self.TAPS == 3 else self.BM
        stage = C // 8 * ((rows + 1) * 8 + (self.BM + 1) * 8)
        self.SMEM = max(self.STAGES * stage * 2,
                        self.TAPS * self.WS * C * (C + 4) * 4)


def test_the_mirror_holds_the_headers_constants():
    conv = (CSRC / "conv3tap.cuh").read_text()
    wgrad = (CSRC / "wgrad3tap.cuh").read_text()
    for line in (
            "static constexpr int NWG = C == 128 ? 2 : 4;",
            "static constexpr int MT = C == 16 ? 2 : 1;",
            "static constexpr int BM = 64 * MT;",
            "static constexpr int KC = C == 16 ? 16 : 32;",
            "static constexpr int ROWS = 3 * BM;",
            "static constexpr int RING_STAGES = 3;",
            "static constexpr int RING = RING_STAGES * ROWS * KC;",
            "static constexpr int MAX_STAGES = 8;",
            "static constexpr int OUT = BM * LDO;",
            "static constexpr int SMEM = (W_ELEMS + NWG * (RING + OUT)) * 2 + 2 * C * 4;",
            "const int nst = min(T::MAX_STAGES, T::RING / stage_elems);",
            "static constexpr int TH = 8;",
            "return d <= (axis == 0 ? TH : BM);",
            "return run() ? t * d * (axis == 0 ? 1 << lgtw() : 1) : t * BM;"):
        assert line in conv, line
    for line in ("static constexpr int BM = 64;",
                 "static constexpr int STAGES = 3;",
                 "static constexpr int TAPS = C == 128 ? 1 : 3;",
                 "static constexpr int NWG = TAPS == 3 ? 3 : 2;",
                 "__global__ void __launch_bounds__(WgradTile<C>::THREADS, 2)",
                 "static constexpr int STAGE = PLANES * (XS + DS);  // bf16",
                 "static constexpr int WS = C == 16 ? 4 : 1;",
                 "static constexpr int XS = (ROWS + 1) * 8;",
                 "static constexpr int DS = (BM + 1) * 8;"):
        assert line in wgrad, line
    assert "static constexpr int THREADS = NWG * 128;" in conv + wgrad


@pytest.mark.parametrize("C", [16, 64, 128])
def test_each_tile_fits_the_cards_shared_memory(C):
    for t in (ConvTile(C), WgradTile(C)):
        assert t.SMEM <= SMEM_BLOCK
        assert t.MIN_BLOCKS * (t.SMEM + 1024) <= SMEM_SM
    # the per-channel sums at the end alias the rings: 2C floats a warp
    T = ConvTile(C)
    assert T.NWG * 4 * 2 * C * 4 <= T.SMEM


@pytest.mark.parametrize("C", [16, 64, 128])
def test_every_plan_keeps_two_chunks_ahead(C):
    """Whatever the plan's rows (a run of BM + 2d for d = 1 .. BM, or three
    bands), a warpgroup's ring holds 3 .. 8 stages, so that the wait depths
    nst - 2 and nst - 1 are ones the tile spells out (1 .. 7), and a run of
    few rows keeps more chunks in flight than the bands do."""
    T = ConvTile(C)
    plans = [T.BM + 2 * d for d in range(1, T.BM + 1)] + [T.ROWS]
    for nload in plans:
        assert 3 <= T.stages(nload) <= 8
        assert T.stages(nload) * nload * T.KC <= T.RING
    assert T.stages(T.BM + 2) >= T.stages(T.ROWS)


def fast_div(n, d):
    """conv3tap.cuh's FastDiv: n // d by a multiply-high, an add and a
    shift, in the kernel's 32-bit arithmetic."""
    s = 0
    while (1 << s) < d:
        s += 1
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    assert m < 1 << 32
    return ((((n * m) >> 32) + n) & 0xFFFFFFFF) >> s


def test_fast_division_is_exact():
    """FastDiv equals integer division for every divisor the tiles take
    (1 .. 4096: W, H, segments a row) and numerators up to 2^31 - 1, the
    largest pixel index."""
    rng = np.random.default_rng(1)
    for d in list(range(1, 4097)) + [65535, 1 << 20, (1 << 31) - 1]:
        n = np.concatenate([np.arange(0, 64), rng.integers(0, 1 << 31, 64),
                            [d - 1, d, d + 1, 2 * d - 1, (1 << 31) - 1]])
        n = n[(n >= 0) & (n < 1 << 31)].astype(object)
        assert [fast_div(int(v), d) for v in n] == [int(v) // d for v in n]


def prologue(x, mul, add):
    return torch.relu(x * mul + add)


class Geo:
    """`TileGeo<BM>` of conv3tap.cuh on arrays: the tiles of a launch and
    the pixels a chunk stages for them."""

    TH = 8

    def __init__(self, BM, H, W, d, axis):
        self.BM, self.H, self.W, self.d, self.axis = BM, H, W, d, axis
        self.th = self.TH if axis == 0 else 1
        self.tw = BM // self.th
        self.nrb = math.ceil(H / self.th)
        self.ncb = math.ceil(W / self.tw)
        self.run = d <= (self.TH if axis == 0 else BM)

    def ntiles(self, B):
        return B * self.nrb * self.ncb

    def nload(self):
        if not self.run:
            return 3 * self.BM
        return ((self.TH + 2 * self.d) * self.tw if self.axis == 0
                else self.BM + 2 * self.d)

    def base(self, t):
        if not self.run:
            return t * self.BM
        return t * self.d * (self.tw if self.axis == 0 else 1)

    def at(self, tile):
        q, cb = tile // self.ncb, tile % self.ncb
        b, rb = q // self.nrb, q % self.nrb
        h0 = rb * self.th
        return b * self.H + h0, h0, cb * self.tw

    def tile_pixel(self, R0, h0, c0, r, col):
        col = c0 + col
        ok = (col >= 0) & (col < self.W) & (h0 + r >= 0) & (h0 + r < self.H)
        return np.where(ok, (R0 + r) * self.W + col, -1)

    def band_pixel(self, R0, h0, c0, t, m):
        off = (t - 1) * self.d
        return self.tile_pixel(R0, h0, c0,
                               m // self.tw + (off if self.axis == 0 else 0),
                               m % self.tw + (off if self.axis == 1 else 0))

    def staged_pixel(self, R0, h0, c0, j):
        j = np.asarray(j, np.int64)
        if not self.run:
            return self.band_pixel(R0, h0, c0, j // self.BM, j % self.BM)
        if self.axis == 1:
            return self.tile_pixel(R0, h0, c0, 0, j - self.d)
        return self.tile_pixel(R0, h0, c0, j // self.tw - self.d,
                               j % self.tw)


def conv_through_plan(x, w, d, axis, grid, mul=None, add=None, mask=True):
    """conv3tap_kernel's plan in float64: -> (out (B, H, W, co), visits a
    tile). `mask=False` applies the prologue to the zero-filled pixels too
    (the control)."""
    B, H, W, C = x.shape
    T = ConvTile(C)
    geo = Geo(T.BM, H, W, d, axis)
    npix = B * H * W
    X = x.reshape(npix, C)
    ntiles = geo.ntiles(B)
    slots = grid * T.NWG
    nload = geo.nload()
    out = torch.zeros(npix, C, dtype=torch.float64)
    visits = np.zeros(ntiles, np.int64)
    for gw in range(slots):
        n = ((ntiles - 1 - gw) // slots + 1 if gw < ntiles else 0) * T.CPT
        for i in range(n):
            tile = gw + i // T.CPT * slots
            R0, h0, c0 = geo.at(tile)
            cc = i % T.CPT
            ch = cc * T.KC
            q = geo.staged_pixel(R0, h0, c0, np.arange(nload))
            ok = torch.from_numpy(q >= 0)
            stage = torch.zeros(nload, T.KC, dtype=torch.float64)
            stage[ok] = X[torch.from_numpy(q[q >= 0]), ch:ch + T.KC]
            if mul is not None:
                rows = ok if mask else slice(None)
                stage[rows] = prologue(stage[rows], mul[ch:ch + T.KC],
                                       add[ch:ch + T.KC])
            if cc == 0:
                visits[tile] += 1
                acc = torch.zeros(T.BM, C, dtype=torch.float64)
            for t in range(3):
                base = geo.base(t)
                assert base + T.BM <= nload
                acc += stage[base:base + T.BM] @ w[t, ch:ch + T.KC]
            if cc == T.CPT - 1:
                p = geo.band_pixel(R0, h0, c0, 1, np.arange(T.BM))
                keep = p >= 0
                out[torch.from_numpy(p[keep])] = acc[torch.from_numpy(keep)]
    return out.reshape(B, H, W, C), visits


def wgrad_through_plan(x, dy, d, axis, slots, mul=None, add=None):
    """wgrad3tap_kernel's plan in float64: -> (dk (3, ci, co), visits of
    each tile by tap)."""
    B, H, W, C = x.shape
    T = WgradTile(C)
    geo = Geo(T.BM, H, W, d, axis)
    npix = B * H * W
    X, D = x.reshape(npix, C), dy.reshape(npix, C)
    ntiles = geo.ntiles(B)
    per = max(slots // 6, 1) if T.TAPS == 1 else slots
    grid = min(ntiles, per)
    dk = torch.zeros(3, C, C, dtype=torch.float64)
    visits = np.zeros((3, ntiles), np.int64)
    for t0 in (range(3) if T.TAPS == 1 else [0]):
        for bx in range(grid):
            part = torch.zeros(T.TAPS, C, C, dtype=torch.float64)
            n = (ntiles - 1 - bx) // grid + 1 if bx < ntiles else 0
            for i in range(n):
                tile = bx + i * grid
                R0, h0, c0 = geo.at(tile)
                if T.TAPS == 3:
                    nload = geo.nload()
                    q = geo.staged_pixel(R0, h0, c0, np.arange(nload))
                else:
                    nload = T.BM
                    q = geo.band_pixel(R0, h0, c0, t0, np.arange(T.BM))
                ok = torch.from_numpy(q >= 0)
                xs = torch.zeros(nload, C, dtype=torch.float64)
                xs[ok] = X[torch.from_numpy(q[q >= 0])]
                if mul is not None:  # on the plane only
                    xs[ok] = prologue(xs[ok], mul, add)
                p = geo.band_pixel(R0, h0, c0, 1, np.arange(T.BM))
                ds = torch.zeros(T.BM, C, dtype=torch.float64)
                ds[torch.from_numpy(p >= 0)] = D[torch.from_numpy(p[p >= 0])]
                for t in range(T.TAPS):
                    base = geo.base(t) if T.TAPS == 3 else 0
                    # C = 16: warp w sums k16 step w (its own partial dk)
                    for k0 in range(0, T.BM, T.BM // T.WS):
                        k1 = k0 + T.BM // T.WS
                        part[t] += xs[base + k0:base + k1].T @ ds[k0:k1]
                    visits[t0 + t, tile] += 1
            dk[t0:t0 + T.TAPS] += part
    return dk, visits


def _plane(shape, seed):
    g = torch.Generator().manual_seed(seed)
    C = shape[-1]
    x = torch.randn(*shape, generator=g, dtype=torch.float64)
    w = torch.randn(3, C, C, generator=g, dtype=torch.float64) / (3 * C) ** .5
    return x, w, g


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


# planes whose tiles are partial at the right and bottom edges: rows of
# several tiles (W = 150) on few of them (H = 6 < 8), and rows narrower than
# a segment on several row blocks (H = 19); d = 1, 2 (runs), 16 (axis 0:
# three bands, all off the image at H = 6) and 80 (axis 1, BM = 64: bands)
PLANES = [(2, 6, 150), (2, 19, 42)]


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("d", [1, 2, 16, 80])
@pytest.mark.parametrize("C", [16, 64, 128])
def test_convolution_through_the_plan(C, d, axis, plane):
    x, w, _ = _plane(plane + (C,), C + d + axis)
    got, visits = conv_through_plan(x, w, d, axis, grid=3)
    assert (visits == 1).all()
    assert _rel(got, _conv3_f64(x, w, axis, d)) < TOL


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("d", [1, 16])
@pytest.mark.parametrize("C", [16, 64, 128])
def test_the_prologue_keeps_the_padding_zero(C, d, axis):
    """Half B's first convolution: z = relu(x * mul + add) with add > 0,
    so relu(add) > 0 where the tap falls off; the plan's z is zero there,
    as the plain version pads z. With the prologue on the zero-filled rows
    too (the control) the plan reads far off."""
    x, w, g = _plane(PLANES[0] + (C,), 7 * C + d + axis)
    mul = 0.5 + torch.rand(C, generator=g, dtype=torch.float64)
    add = 0.2 + torch.rand(C, generator=g, dtype=torch.float64)
    want = _conv3_f64(prologue(x, mul, add), w, axis, d)
    got, _ = conv_through_plan(x, w, d, axis, 3, mul, add)
    assert _rel(got, want) < TOL
    ctl, _ = conv_through_plan(x, w, d, axis, 3, mul, add, mask=False)
    assert _rel(ctl, want) > 1e-2


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("C", [16, 64, 128])
def test_the_d_beyond_the_plane_edge(C, axis):
    """The resize-64 NB1D-128 plane (8x16) with d = 16 >= H, W: the
    shifted taps read only zeros, with and without the prologue."""
    x, w, g = _plane((2, 8, 16, C), 3 * C + axis)
    mul = 0.5 + torch.rand(C, generator=g, dtype=torch.float64)
    add = 0.2 + torch.rand(C, generator=g, dtype=torch.float64)
    for m, a in ((None, None), (mul, add)):
        z = x if m is None else prologue(x, m, a)
        got, visits = conv_through_plan(x, w, 16, axis, 2, m, a)
        assert (visits == 1).all()
        assert _rel(got, _conv3_f64(z, w, axis, 16)) < TOL
        # only the centre tap reaches the plane
        assert _rel(got, (z @ w[1]).reshape(got.shape)) < TOL


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("prologue_on", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("d", [1, 2, 16, 80])
@pytest.mark.parametrize("C", [16, 64, 128])
def test_weight_gradient_through_the_plan(C, d, axis, prologue_on, plane):
    x, _, g = _plane(plane + (C,), 11 * C + d + axis)
    dy = torch.randn(*x.shape, generator=g, dtype=torch.float64)
    mul = add = None
    z = x
    if prologue_on:
        mul = 0.5 + torch.rand(C, generator=g, dtype=torch.float64)
        add = 0.2 + torch.rand(C, generator=g, dtype=torch.float64)
        z = prologue(x, mul, add)
    # 21 blocks the card holds (3 a tap at C = 128): tiles split unevenly
    got, visits = wgrad_through_plan(x, dy, d, axis, 21, mul, add)
    assert (visits == 1).all()
    assert _rel(got, _wgrad3(z, dy, axis, d)) < TOL


@pytest.mark.parametrize("C", [16, 64, 128])
def test_the_operand_copies_fill_the_core_matrices_once(C):
    """The tap matrices: copy e (16 bytes) of w[t][ci][co] lands at
    element 8e of the staged buffer, which is t*C*C + mn_index(ci, co),
    wgmma's MN-major layout (leading offset 16C bytes between 8 k,
    stride offset 128 bytes between 8 n), each element once."""
    def mn_index(k, n, N):
        return (k // 8) * 8 * N + (n // 8) * 64 + (k % 8) * 8 + n % 8
    e = np.arange(3 * C * C // 8)
    r, nb_, kb = e % 8, e // 8 % (C // 8), e // 8 // (C // 8) % (C // 8)
    t = e // (C * C // 8)
    ci, co = kb * 8 + r, nb_ * 8
    for j in range(8):
        assert (t * C * C + mn_index(ci, co + j, C) == 8 * e + j).all()
    seen = np.zeros(3 * C * C, np.int64)
    for j in range(8):
        np.add.at(seen, (t * C + ci) * C + co + j, 1)
    assert (seen == 1).all()
    # the descriptor's offsets: element (k, n) of a k16 slice
    k, n = np.meshgrid(np.arange(16), np.arange(C), indexing="ij")
    lbo, sbo = 16 * C, 128
    assert (2 * mn_index(k, n, C) == (k // 8) * lbo + (n // 8) * sbo
            + (k % 8) * 16 + (n % 8) * 2).all()


@pytest.mark.parametrize("C", [16, 64, 128])
def test_the_weight_gradients_operands_fill_their_planes(C):
    """The weight gradient's copies: staged input pixel j, channels 8v ..
    8v + 7 at element v * XS + 8j, a tile's dy pixel m at v * DS + 8m, each
    once and apart from the other operand; the transposed forms read
    element (m, k) of an A slice (input channel m of staged pixel base + k)
    at byte (m / 8) * 2 XS + (k / 8) * 128 + (k % 8) * 16 + (m % 8) * 2 from
    its start (plane_desc: leading offset 128, stride offset the plane),
    the plane's 16-byte pad putting a warp's 32 copies in 8 banks of 4; at
    C = 16 (mma.sync) the lanes' ldmatrix.trans rows cover each operand's
    four 8 x 8 blocks once, in the order of the fragments."""
    T = WgradTile(C)
    rows = 3 * T.BM if T.TAPS == 3 else T.BM
    xs, ds = (rows + 1) * 8, (T.BM + 1) * 8
    xp = C // 8
    e = np.arange(rows * (C // 8))
    j, v = e // (C // 8), e % (C // 8)
    dst_x = v * xs + j * 8
    e = np.arange(T.BM * (C // 8))
    dst_d = xp * xs + e % (C // 8) * ds + e // (C // 8) * 8
    both = np.concatenate([dst_x, dst_d])
    assert len(set(both)) == len(both)
    assert (np.sort(dst_d) >= xp * xs).all() and dst_x.max() < xp * xs
    for first in (dst_x[:32], dst_d[:32]):  # a warp's copies
        assert np.bincount(first // 8 % 8, minlength=8).max() == 4
    base = 7
    if C == 16:
        # mma.sync: lane l's ldmatrix.trans row of A, k16 step ks from
        # staged pixel base, is pixel base + 16 ks + 8 (l / 16) + l % 8 of
        # plane l / 8 % 2, and of B pixel 16 ks + 8 (l / 8 % 2) + l % 8 of
        # plane l / 16: matrix i = l / 8 holds A's (ci 8 (i % 2), k 8 (i /
        # 2)) block and B's (k 8 (i % 2), co 8 (i / 2)) block
        lane, ks = np.arange(32), 3
        mat, r = lane // 8, lane % 8
        a_row = lane // 8 % 2 * xs + (base + ks * 16 + lane // 16 * 8 + r) * 8
        assert (a_row == (mat % 2) * xs
                + (base + ks * 16 + 8 * (mat // 2) + r) * 8).all()
        b_row = xp * xs + lane // 16 * ds + (ks * 16 + lane // 8 % 2 * 8
                                             + r) * 8
        assert (b_row == xp * xs + (mat // 2) * ds
                + (ks * 16 + 8 * (mat % 2) + r) * 8).all()
        for rows_ in (a_row, b_row):  # 16-byte rows, each element once
            assert (rows_ % 8 == 0).all()
            assert len(set((rows_[:, None] + np.arange(8)).ravel())) == 256
        return
    m, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    byte = (m // 8) * 2 * xs + (k // 8) * 128 + (k % 8) * 16 + (m % 8) * 2
    assert (byte // 2 + base * 8 == (m // 8) * xs + (base + k) * 8 + m % 8
            ).all()


@pytest.mark.parametrize("C", [16, 64, 128])
def test_the_staged_rows_fill_the_column_planes(C):
    """Copy e of a chunk stages 16 bytes of row j = e / PLANES into column
    plane v = e % PLANES at element v * plane + 8j (plane = nload * 8),
    each (row, plane) once; a k16 slice of tap t's view, its rows from any
    staged row `base`, is then the K-major operand wgmma reads through
    k_desc: element (m, k) at byte (k / 8) * LBO + (m / 8) * 128 + (m % 8)
    * 16 + (k % 8) * 2 from its start, LBO = 16 * nload, and holds staged
    row base + m, channel k."""
    T = ConvTile(C)
    for nload in (T.BM + 2, T.BM + 32, T.ROWS):
        plane = nload * 8
        e = np.arange(nload * T.PLANES)
        j, v = e // T.PLANES, e % T.PLANES
        dst = v * plane + j * 8
        assert len(set(dst)) == len(e) and dst.max() < T.KC * nload
        for base in (0, 1, 5, nload - 64):
            m, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
            byte = (k // 8) * 16 * nload + (m // 8) * 128 + (m % 8) * 16 + (
                k % 8) * 2
            elem = byte // 2 + base * 8  # from the slice's start
            assert (elem == (k // 8) * plane + (base + m) * 8 + k % 8).all()


class _Fn:
    """A stand-in of an `ld_nb_half_*_info` entry: records (B, H, W, C, d)
    and fills five ints a kernel, the kernel's value first."""

    def __init__(self, per_kernel):
        self.per_kernel, self.calls = per_kernel, []

    def __call__(self, B, H, W, C, d, addr):
        self.calls.append((B, H, W, C, d))
        n = len(self.per_kernel)
        buf = (ctypes.c_int * (5 * n)).from_address(addr)
        for i, v in enumerate(self.per_kernel):
            buf[5 * i:5 * i + 5] = [v, 0, 1, 1000 + i, 100 + i]
        return 0


def test_tile_info_reads_each_librarys_entry(monkeypatch):
    """`ops/nb_block.py::tile_info` asks each library for its info entry
    with the plane and d, and names the kernels in the entry's order, the
    bf16 tiles first; it refuses other channel counts before any call."""
    fns = {"nb_half_fwd": _Fn([100, 101, 110, 111]),
           "nb_half_bwd": _Fn([200, 201, 202, 203, 210, 211, 212])}
    asked = []

    def fake_kernel(lib, symbol, signature):
        asked.append((lib, symbol, signature))
        return fns[lib]

    monkeypatch.setattr(nb, "kernel", fake_kernel)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    info = nb.tile_info((8, 64, 128, 64), 1, "cuda")
    assert asked == [("nb_half_fwd", "ld_nb_half_fwd_info", "iiiiip"),
                     ("nb_half_bwd", "ld_nb_half_bwd_info", "iiiiip")]
    assert (fns["nb_half_fwd"].calls == [(8, 64, 128, 64, 1)]
            == fns["nb_half_bwd"].calls)
    assert list(info["bfloat16"]) == [
        *nb.TILE_KERNELS["nb_half_fwd"]["bfloat16"],
        *nb.TILE_KERNELS["nb_half_bwd"]["bfloat16"]]
    assert info["bfloat16"]["wgrad"] == {
        "registers": 203, "local_bytes": 0, "blocks_per_sm": 1,
        "smem_bytes": 1003, "blocks": 103}
    with pytest.raises(ValueError, match="C=32"):
        nb.tile_info((1, 8, 8, 32), 1, "cuda")


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
