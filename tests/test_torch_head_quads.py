"""K9's 2x2 output head (`lane_maps_op` at k = 2) on K10's head tile, and
`channel_sums` as a fixed-order reduction, on the CPU.

The head's backward kernel (`csrc/lane_maps_op.cu`, on
`csrc/head_quads.cuh`'s pass, the one K10 runs) is one pass over the
input: per input pixel, its quad's output gradient read from dy as it is,
dp = dy rounded to x's dtype, dx from that quad, and the pixel's share of
dweight; dweight and dbias as partials over tiles of `HEAD_BWD_TILE`
input pixels, then the tiles' partials added in the fold of
`tests/test_torch_head_tail.py::lane_fold`. `head_quads_bwd` writes that
order in plain PyTorch (inside a tile by matmul: the kernel's fused
multiply-adds have no bit-exact counterpart on the CPU, so what is checked
is the formulation and the tiles' sum, not the kernel's float32
rounding, which `chip_smoke.py` holds on the card, bit for bit across
launches):

- in float64 it equals the transposed convolution's gradients (a strided
  convolution, its weight gradient and a sum) to 1e-12 of max|reference|,
  at every lane count the head tile takes, 3 (not a power of two) too;
- in float32 it holds the plain backward `lane_maps_bwd_plain` at
  TOL_F32 = 1e-4 of max|plain| (the bar the card holds the kernel to) and
  the JAX package's `head_packed` (`pallas=True`, interpret mode) at
  tests/test_torch_lanemaps.py's bars, at cout 2 and 4.

`sums_ordered` writes the channel_sums kernel's partition and order
(`csrc/channel_sums.cu`: per thread 8 pixels in order, the xor fold of the
lanes that share channels, the warps in order, the blocks' columns by
`lane_fold`): in float64 it equals the plain sums to 1e-12; in float32 on
the 16-channel plane of the 256x512 step at batch 8 (262,144 values a
channel, bf16 values) its sum of squares lies within 5e-7 of a float64
sum, where a sequential float32 sum misses it (it reads about 1e-4; the
ordered sum about 1.2e-7).

Then the CUDA wrappers with `kernel`, `launch` and `check_cuda` stubbed:
the head asks for its dtype's entries with the parameter as it lies, no
moments, no dp plane and no zero fill; the pure checks refuse other
geometries and any moments at k = 2; channel_sums asks for its entry with
the partial sums' scratch and no zero fill, and refuses a channel count
the kernel does not take, before any launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.ops import packed_graph as pg
from lanedetection_end2end_tpu_torch.models.port import conv_transpose_state
from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
from lanedetection_end2end_tpu_torch.ops import packed_conv as pc
from lanedetection_end2end_tpu_torch.ops import packed_graph as tg
from test_torch_f32_fused import Stubs
from test_torch_head_tail import lane_fold
from test_torch_lanemaps import _assert_grads, _convt_kernel
from test_torch_threads import one_torch_thread  # noqa: F401

B, CIN = 2, 16
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
TOL_F32 = 1e-4


def head_quads_bwd(x, dy, weight, tile=lm.HEAD_BWD_TILE):
    """K9's head backward in its kernel's order: x (B, H, W, cin), dy (B,
    2H, 2W, C), the parameter weight (cin, C, 2, 2) -> (dx, dweight,
    dbias). Sums in float64 for a float64 plane, else f32; dp and dx
    rounded to x's dtype where the kernel rounds them."""
    acc = F64 if x.dtype == F64 else F32
    rnd = lambda t: t.to(x.dtype).to(acc)
    Bn, Hh, Wh, cin = x.shape
    C = weight.shape[1]
    K = rnd(weight)                                    # (cin, C, i, j)
    # each input pixel's quad of dy: g[b, h, w, i, j, c]
    g = dy.to(acc).reshape(Bn, Hh, 2, Wh, 2, C).permute(0, 1, 3, 2, 4, 5)
    dp = rnd(g)
    dx = torch.einsum("bhwijc,kcij->bhwk", dp, K).to(x.dtype)
    X = x.to(acc).reshape(-1, cin)
    D = dp.reshape(-1, 4 * C)                          # (i, j, c)
    G = g.reshape(-1, 4, C)
    tiles = range(0, X.shape[0], tile)
    dw = lane_fold([X[t0:t0 + tile].T @ D[t0:t0 + tile] for t0 in tiles])
    dbias = lane_fold([G[t0:t0 + tile].sum((0, 1)) for t0 in tiles])
    return dx, dw.reshape(cin, 2, 2, C).permute(0, 3, 1, 2), dbias


def _case(seed, C, dtype, H=16, W=40):
    """x (B, H, W, 16) of `dtype`, dy (B, 2H, 2W, C) and the parameter in
    its dtype (float64 with a float64 plane, else f32). B H W = 1280
    pixels: two whole tiles of 512 and a partial one."""
    rng = np.random.default_rng(seed)
    wdt = F64 if dtype == F64 else F32
    f = lambda *s, scale=1.0: torch.from_numpy(rng.normal(0, scale, s))
    return (f(B, H, W, CIN).to(dtype), f(B, 2 * H, 2 * W, C).to(wdt),
            f(CIN, C, 2, 2, scale=0.3).to(wdt))


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.parametrize("C", [1, 2, 3, 4, 8])
def test_head_quads_equal_the_gradients_in_float64(C):
    x, dy, w = _case(C, C, F64)
    dx, dweight, dbias = head_quads_bwd(x, dy, w)
    assert dx.dtype == F64 and dweight.shape == (CIN, C, 2, 2)
    # the stride-2 convolution of dy and its weight gradient with x
    assert _rel(dx, lm.conv_s2(dy, w, 2)) < 1e-12
    assert _rel(dweight, lm.wgrad_s2(x, dy, 2)) < 1e-12
    assert _rel(dbias, dy.sum((0, 1, 2))) < 1e-12


@pytest.mark.parametrize("C", [2, 4])
def test_head_quads_hold_the_plain_backward_in_float32(C):
    x, dy, w = _case(10 + C, C, F32)
    got = head_quads_bwd(x, dy, w)
    want = lm.lane_maps_bwd_plain(x, None, dy, None, w, 2)
    for name, a, b in zip(("dx", "dweight", "dbias"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel(a, b) < TOL_F32, name


@pytest.mark.parametrize("C", [2, 4])
def test_head_quads_match_jax_head(C, monkeypatch):
    """The kernel's order against the JAX head's gradients (interpret mode)
    at tests/test_torch_lanemaps.py's bars."""
    monkeypatch.setenv("PACKED_FUSED_MAPS", "1")
    rng = np.random.default_rng(20 + C)
    H, W = 4, 32  # JAX's head packs 32 pixels a row at cout 2
    x = rng.normal(0, 1, (B, H, W, CIN)).astype(np.float32)
    params = {"kernel": rng.normal(0, 0.2, (2, 2, CIN, C)).astype(np.float32),
              "bias": rng.normal(0, 0.1, C).astype(np.float32)}
    wy = rng.normal(0, 1, (B, 2 * H, 2 * W, C)).astype(np.float32)

    def f(p, xx):
        y = pg.head_packed(xx.reshape(B, H, -1), p, cin=CIN, cout=C,
                           pallas=True).reshape(wy.shape)
        return jnp.sum(y * wy)
    gp, gx = jax.grad(f, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    conv = torch.nn.ConvTranspose2d(CIN, C, 2, stride=2)
    conv.load_state_dict({k[len("b."):]: v for k, v in
                          conv_transpose_state(params, "b").items()})
    dx, dweight, dbias = head_quads_bwd(torch.from_numpy(x),
                                        torch.from_numpy(wy),
                                        conv.weight.detach())
    _assert_grads({"x": dx.numpy(), "kernel": _convt_kernel(dweight),
                   "bias": dbias.numpy()},
                  {"x": np.asarray(gx), "kernel": np.asarray(gp["kernel"]),
                   "bias": np.asarray(gp["bias"])})


# ----------------------------------------------------------------------
# The head's wrappers and checks, launches stubbed
# ----------------------------------------------------------------------

@pytest.fixture
def stubs(monkeypatch):
    s = Stubs()
    allocated, zeroed = [], []
    empty, zeros = torch.empty, torch.zeros

    def watched_empty(*shape, **kw):
        t = empty(*shape, **kw)
        allocated.append(tuple(t.shape))
        return t

    def watched_zeros(*shape, **kw):
        t = zeros(*shape, **kw)
        zeroed.append(tuple(t.shape))
        return t
    for mod in (lm, pc):
        for name in ("kernel", "launch", "check_cuda"):
            monkeypatch.setattr(mod, name, getattr(s, name))
    monkeypatch.setattr(torch, "empty", watched_empty)
    monkeypatch.setattr(torch, "zeros", watched_zeros)
    for f in (lm.lane_maps_op, pc.channel_sums):
        monkeypatch.setattr(f, "launches", 0)
    monkeypatch.setattr(lm.lane_maps_op, "bwd_launches", 0)
    s.allocated, s.zeroed = allocated, zeroed
    return s


def _meta(*shape, dtype=F32):
    return torch.empty(*shape, dtype=dtype, device="meta")


SUFFIX = {BF16: "", F32: "_f32"}


@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bfloat16", "float32"])
def test_head_wrappers_ask_for_one_pass(stubs, dtype, C):
    H, W = 64, 128
    x = _meta(B, H, W, CIN, dtype=dtype)
    w, bias, dy = _meta(CIN, C, 2, 2), _meta(C), _meta(B, 2 * H, 2 * W, C)
    stubs.allocated.clear()
    y, mom = lm._lane_maps_fwd_cuda(x, w, bias, 2, F32, False)
    assert stubs.allocated == [(B, 2 * H, 2 * W, C)]       # y alone
    stubs.allocated.clear()
    dx, dweight, dbias = lm.lane_maps_bwd_kernel(x, None, dy, None, w, 2)
    # the partial sums and dbias; dx and dweight like x and the parameter
    assert stubs.allocated == [(lm.head_part_floats(B * H * W, C),), (C,)]
    assert [(n, s) for n, s, _ in stubs.calls] == [
        ("lane_maps_op", "ld_lane_maps_op_fwd" + SUFFIX[dtype]),
        ("lane_maps_op", "ld_lane_maps_op_bwd" + SUFFIX[dtype])]
    fwd, bwd = (args for _, _, args in stubs.calls)
    # forward: x, the parameter as it lies, bias, y, no moments (and no
    # moments' partials)
    assert fwd[4] is None and fwd[5] is None
    assert fwd[-6:] == (CIN, C, 2, 0, 1, 0)
    # backward: no y, no moment cotangent, the partial sums' scratch, no
    # partials of the upsamplers' fold
    assert bwd[1] is None and bwd[3] is None and bwd[9] is None
    assert bwd[-9:] == (B, H, W, CIN, C, 2, 0, 1, 0)
    assert stubs.zeroed == []  # no dp plane above, and no zero fill
    assert mom is None and y.shape == (B, 2 * H, 2 * W, C) and y.dtype == F32
    assert dx.shape == x.shape and dx.dtype == dtype
    assert dweight.shape == (CIN, C, 2, 2) and dbias.shape == (C,)
    assert (lm.lane_maps_op.launches, lm.lane_maps_op.bwd_launches) == (1, 1)


GEOMETRY = {  # (cin, cout) at k = 2 -> taken
    **{f"{CIN}->{c}": ((CIN, c), True) for c in range(1, 9)},
    "16->0": ((CIN, 0), False), "16->9": ((CIN, 9), False),
    "16->16": ((CIN, 16), False), "8->2": ((8, 2), False),
    "32->4": ((32, 4), False)}


@pytest.mark.parametrize("case", sorted(GEOMETRY))
def test_head_geometry_check(case):
    (cin, cout), taken = GEOMETRY[case]
    if taken:
        lm._check_shape("lane_maps_op", cin, cout, 2)
    else:
        with pytest.raises(ValueError, match="not a shape the kernels"):
            lm._check_shape("lane_maps_op", cin, cout, 2)


@pytest.mark.parametrize("cout", [1, 2, 4, 8])
def test_head_moments_refused_at_any_lane_count(cout):
    with pytest.raises(ValueError, match="takes no moments"):
        lm._check_lane_maps_moments(2, cout)


def test_upsampler_moments_keep_their_channels():
    for cout in (64, 16):
        lm._check_lane_maps_moments(3, cout)
    with pytest.raises(ValueError, match="channels not in"):
        lm._check_lane_maps_moments(3, 32)


def test_head_lanes_pad_as_the_tile():
    assert [lm.head_lanes(c) for c in range(1, 9)] == [1, 2, 4, 4, 8, 8, 8, 8]
    # 65 entries a padded lane, one column per tile of 512 pixels
    assert lm.head_part_floats(1025, 3) == 65 * 4 * 3


@pytest.mark.parametrize("cout", [9, 16])
def test_head_refuses_more_lanes_before_any_launch(stubs, cout):
    x = _meta(B, 4, 8, CIN)
    with pytest.raises(ValueError, match="not a shape the kernels"):
        lm._lane_maps_fwd_cuda(x, _meta(CIN, cout, 2, 2), _meta(cout), 2,
                               F32, False)
    with pytest.raises(ValueError, match="not a shape the kernels"):
        lm.lane_maps_bwd_kernel(x, None, _meta(B, 8, 16, cout), None,
                                _meta(CIN, cout, 2, 2), 2)
    assert stubs.calls == []


# ----------------------------------------------------------------------
# channel_sums in its kernel's order
# ----------------------------------------------------------------------

def sums_ordered(x, itemsize, loads=pc.SUMS_LOADS, threads=pc.SUMS_THREADS):
    """channel_sums in its kernel's partition and order for planes of
    `itemsize` bytes a value: x (..., C) -> (2, C), in float64 for a
    float64 tensor, else f32 (squares rounded before the add, where the
    kernel fuses them)."""
    acc = F64 if x.dtype == F64 else F32
    C = x.shape[-1]
    xf = x.to(acc).reshape(-1, C)
    vpr = C * itemsize // 16                 # 16-byte vectors a pixel
    rpi = threads // vpr                     # pixels a round of loads
    nblk = pc.channel_sums_blocks(xf.shape[0], C, itemsize)
    xf = torch.cat([xf, xf.new_zeros(nblk * rpi * loads - xf.shape[0], C)])
    xb = xf.reshape(nblk, loads, rpi, C)     # pixel b, u, r
    s1 = torch.zeros(nblk, rpi, C, dtype=acc)
    s2 = torch.zeros_like(s1)
    for u in range(loads):
        s1 = s1 + xb[:, u]
        s2 = s2 + xb[:, u] * xb[:, u]

    def block(s):
        # a warp holds 32 / vpr pixel rows; its lanes of one vector fold
        # by halves (xor shuffles), then the warps add in order
        t = s.reshape(nblk, threads // 32, 32 // vpr, C)
        off = t.shape[2] // 2
        while off:
            t = t[:, :, :off] + t[:, :, off:2 * off]
            off //= 2
        a = torch.zeros(nblk, C, dtype=acc)
        for wp in range(threads // 32):
            a = a + t[:, wp, 0]
        return a
    cols = torch.cat([block(s1), block(s2)], dim=1)     # (nblk, 2C)
    return lane_fold(list(cols)).reshape(2, C)


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(2, 8, 32, 16), (2, 8, 8, 64),
                                   (1, 5, 7, 128), (3, 4, 4, 8)])
def test_sums_ordered_equal_the_plain_sums_in_float64(shape, itemsize):
    x = torch.from_numpy(np.random.default_rng(0).normal(0.3, 1, shape))
    got = sums_ordered(x, itemsize)
    want = torch.stack([x.reshape(-1, shape[-1]).sum(0),
                        (x * x).reshape(-1, shape[-1]).sum(0)])
    assert _rel(got, want) < 1e-12


def test_sums_ordered_beside_a_float64_witness():
    """The 16-channel plane of the 256x512 step, bf16 values: the ordered
    f32 sum of squares within 5e-7 of the float64 sum; a sequential f32
    sum (the control) misses that bar."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 128, 256, 16, generator=g).to(BF16)
    got = sums_ordered(x, 2)
    xd = x.double().reshape(-1, 16)
    want = torch.stack([xd.sum(0), (xd * xd).sum(0)])
    assert _rel(got[1], want[1]) < 5e-7
    assert _rel(got[0], want[0]) < 5e-7
    seq = np.add.accumulate((xd * xd).float().numpy(), axis=0,
                            dtype=np.float32)[-1]
    assert _rel(torch.from_numpy(seq), want[1]) > 5e-7


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bfloat16", "float32"])
def test_channel_sums_wrapper_asks_for_two_launches_no_fill(stubs, dtype):
    x = _meta(8, 64, 128, 64, dtype=dtype)
    stubs.allocated.clear()
    out = pc._channel_sums_cuda(x)
    assert [(n, s) for n, s, _ in stubs.calls] == [
        ("channel_sums", "ld_channel_sums")]
    args = stubs.calls[0][2]
    npix, size = 8 * 64 * 128, dtype.itemsize
    assert args[-3:] == (npix, 64, int(dtype == F32))
    nblk = pc.channel_sums_blocks(npix, 64, size)
    assert nblk == -(-npix // (256 // (64 * size // 16) * 8))
    assert stubs.allocated == [(2 * 64 * nblk,), (2, 64)]
    assert stubs.zeroed == [] and out.shape == (2, 64)
    assert pc.channel_sums.launches == 1


@pytest.mark.parametrize("C", [24, 256, 4])
def test_channel_sums_refuses_before_any_launch(stubs, C):
    with pytest.raises(ValueError, match="power of two"):
        pc._channel_sums_cuda(_meta(2, 4, 4, C, dtype=BF16))
    assert stubs.calls == []
