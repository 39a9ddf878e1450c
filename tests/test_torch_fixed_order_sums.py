"""The fixed-order sums of the float32 training kernels K6-K9 and K11's
float32 weight gradient, on the CPU (the bf16 tiles' and K11's bias
gradient: `tests/test_torch_fixed_order_bf16.py`).

Each kernel that sums over blocks writes one row of partials per block and
`csrc/fold.cuh` adds the rows in the order `ops/fold.py::fold_rows` writes
(the model is `tests/test_torch_head_tail.py::lane_fold`, K10's). The
block partitions depend on the shape alone and are counted by the
wrappers (`ops/nb_block.py`: `conv_rows`, `wgrad_split`, `dyv_split`;
`ops/lanemaps.py`: `S2_ROWS`, `s2_wgrad_split`, `fold.ew_rows`). Here, in
float64, each sum is split the way its kernel splits it, the blocks'
partials are folded in that order, and the result equals the plain sum
(the unsplit sum over every pixel) to 1e-12 of max:

- K6 / K7 (`csrc/conv3tap_f32.cuh`, `csrc/nb_half_bwd.cu`): the moments
  and the masked sums (dbh; dmul and dadd of half B) over the
  convolution's persistent blocks (each the groups of NWG tiles dealt to
  it in turn), dbw over the grid-stride blocks of the
  dyv pass, dkh and dkw over the weight gradient's runs of whole pixel
  chunks, at C = 16, 64 and 128 (K11's float32 weight gradient is the
  same tile);
- K8 / K9 (`csrc/downsampler_op.cu`, `csrc/lane_maps_op.cu`,
  `csrc/conv_s2_mma.cuh`, `csrc/conv_s2.cuh`): the moments over the
  stride-2 GEMM's 64-pixel blocks (K9: of each output parity) or the
  first downsampler's grid-stride blocks, the bias gradient over the dyv
  fold's grid-stride blocks of values, the weight gradient over the
  stride-2 weight gradient's chunk runs (the bf16 and the float32 tiles'
  partitions) or the first downsampler's.

Then the CUDA wrappers with `kernel`, `launch` and `check_cuda` stubbed:
each asks for its entry with a partials scratch of the floats its kernels
take and no zero fill of what the fold writes, in both dtypes. Last, the train step runs
cuDNN's deterministic algorithms exactly where the heads are its only
cuDNN convolutions (the packed path with fused maps)."""

import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
from lanedetection_end2end_tpu_torch.ops import nb_block as nb
from lanedetection_end2end_tpu_torch.ops import packed_conv as pc
from lanedetection_end2end_tpu_torch.ops.fold import cdiv, ew_rows, fold_rows
from test_torch_f32_fused import Stubs
from test_torch_threads import one_torch_thread  # noqa: F401

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
TOL = 1e-12


def _close(got, want):
    assert got.shape == want.shape
    assert (got - want).abs().max() <= TOL * want.abs().max()


def _rn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape))


def _conv3(t, w, axis: int, d: int):
    """The 3-tap convolution of `ops/nb1d.py::_conv3` in t's dtype (that
    one computes in float32)."""
    k = w.to(t.dtype).permute(2, 1, 0)                 # (co, ci, 3)
    if axis == 0:
        weight, pad, dil = k.unsqueeze(-1), (d, 0), (d, 1)
    else:
        weight, pad, dil = k.unsqueeze(2), (0, d), (1, d)
    y = torch.nn.functional.conv2d(t.permute(0, 3, 1, 2), weight,
                                   padding=pad, dilation=dil)
    return y.permute(0, 2, 3, 1)


def tile_of(shape, axis: int, bm: int) -> torch.Tensor:
    """(npix,) the tile of each pixel: tiles of one image, 8 rows x bm / 8
    columns (axis 0) or bm columns of a row (axis 1), numbered by image,
    block of rows, block of columns (`TileGeo::at`, the 3-tap tiles' in
    both dtypes)."""
    B, H, W, _ = shape
    th = 8 if axis == 0 else 1
    tw = bm // th
    b, h, w = torch.meshgrid(torch.arange(B), torch.arange(H),
                             torch.arange(W), indexing="ij")
    return ((b * cdiv(H, th) + h // th) * cdiv(W, tw) + w // tw).reshape(-1)


def f32_conv_blocks(shape, axis: int) -> torch.Tensor:
    """(npix,) the block of each pixel of the float32 convolution: its
    tile's group of NWG (`nb.F32_CONV`), groups dealt to the blocks in
    turn (`nb.conv_rows`)."""
    nwg, bm = nb.F32_CONV[shape[-1]]
    return tile_of(shape, axis, bm) // nwg % nb.conv_rows(shape, axis)


def stride_rows(values, per: int, blocks: int, idx=None):
    """(n, ...) -> (blocks, ...): a grid-stride walk, block b taking items
    b per + [0, per) of each round of blocks * per; or item i to block
    idx[i]."""
    if idx is None:
        idx = (torch.arange(values.shape[0]) // per) % blocks
    out = torch.zeros(blocks, *values.shape[1:], dtype=values.dtype)
    return out.index_add_(0, idx, values)


# ----------------------------------------------------------------------
# K6 / K7: the half blocks' sums
# ----------------------------------------------------------------------

def wgrad_rows(a, dy, axis: int, d: int):
    """The weight gradient's blocks: each a run of whole pixel chunks ->
    (blocks, 3, C, C) partials of sum_t shift_t(a)^T dy."""
    C = a.shape[-1]
    npix = a.numel() // C
    _, ppb = nb.wgrad_split(C, npix)
    dyf = dy.reshape(npix, C)
    taps = [nb._shift(a, (t - 1) * d, 1 + axis).reshape(npix, C)
            for t in range(3)]
    return torch.stack([
        torch.stack([s[p0:p0 + ppb].T @ dyf[p0:p0 + ppb] for s in taps])
        for p0 in range(0, npix, ppb)])


def half_sums_ordered(x, mul, add, ymid, yout, dyout, dmom, kh, kw, d):
    """The sums of the float32 half blocks, forward and backward, each in
    its kernels' partition and fold order (float64 in, float64 out) ->
    {name: tensor}, the plain backward's arithmetic otherwise."""
    C = x.shape[-1]
    npix = x.numel() // C
    flat = lambda t: t.reshape(npix, C)
    conv_blocks = lambda t, axis: fold_rows(stride_rows(
        flat(t), 1, nb.conv_rows(x.shape, axis),
        f32_conv_blocks(x.shape, axis)))
    out = {"mom": torch.stack([conv_blocks(yout, 1),
                               conv_blocks(yout * yout, 1)])}
    z = x if mul is None else torch.relu(x * mul + add)
    dyv = dyout + dmom[0] + 2.0 * yout * dmom[1]
    blocks, rpi = nb.dyv_split(C, npix)
    out["dbw"] = fold_rows(stride_rows(flat(dyv), rpi, blocks))
    out["dkw"] = fold_rows(wgrad_rows(ymid, dyv, 1, d))
    dmid = _conv3(dyv, nb._transposed_taps(kw), 1, d) * (ymid > 0)
    out["dbh"] = conv_blocks(dmid, 1)
    out["dkh"] = fold_rows(wgrad_rows(z, dmid, 0, d))
    if mul is not None:
        dz = _conv3(dmid, nb._transposed_taps(kh), 0, d) * (x * mul + add > 0)
        out["dmul"], out["dadd"] = conv_blocks(dz * x, 0), conv_blocks(dz, 0)
    return out


def half_sums_plain(x, mul, add, ymid, yout, dyout, dmom, kh, kw, d):
    """The same sums over every pixel at once (the plain backward's)."""
    S = nb._SUM
    out = {"mom": nb._moments(yout)}
    z = x if mul is None else torch.relu(x * mul + add)
    dyv = dyout + dmom[0] + 2.0 * yout * dmom[1]
    out["dbw"], out["dkw"] = dyv.sum(S), nb._wgrad3(ymid, dyv, 1, d)
    dmid = _conv3(dyv, nb._transposed_taps(kw), 1, d) * (ymid > 0)
    out["dbh"], out["dkh"] = dmid.sum(S), nb._wgrad3(z, dmid, 0, d)
    if mul is not None:
        dz = _conv3(dmid, nb._transposed_taps(kh), 0, d) * (x * mul + add > 0)
        out["dmul"], out["dadd"] = (dz * x).sum(S), dz.sum(S)
    return out


# (half, plane, d): each channel count; planes of several convolution
# tiles, weight-gradient blocks and dyv rounds (C = 16: 132 x 128 pixels
# of dyv blocks a round, and a second round)
HALVES = {"a C=16": ("a", (2, 96, 192, 16), 1),
          "b C=64": ("b", (2, 32, 64, 64), 2),
          "b C=128": ("b", (2, 16, 32, 128), 4),
          "a C=128 d=16": ("a", (1, 8, 16, 128), 16)}


@pytest.mark.parametrize("case", sorted(HALVES))
def test_half_block_sums_fold_to_the_plain_sums(case):
    half, shape, d = HALVES[case]
    C = shape[-1]
    rng = np.random.default_rng(hash(case) % 2 ** 32)
    x, ymid, yout, dyout = (_rn(rng, *shape) for _ in range(4))
    ymid = torch.relu(ymid)
    kh, kw = _rn(rng, 3, C, C), _rn(rng, 3, C, C)
    dmom = 1e-2 * _rn(rng, 2, C)
    mul = add = None
    if half == "b":
        mul, add = _rn(rng, C).abs() + 0.5, _rn(rng, C)
    args = (x, mul, add, ymid, yout, dyout, dmom, kh, kw, d)
    got, want = half_sums_ordered(*args), half_sums_plain(*args)
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name])


def test_the_partitions_split_the_step_as_the_kernels_do():
    """At the 256x512 step's planes, batch 8: the weight gradients at most
    44 / 88 / 132 blocks a tap (one wave), the dyv pass 1056 blocks, the
    convolution a block a group of its tiles, at most one wave."""
    assert nb.wgrad_split(128, 8 * 32 * 64) == (43, 384)
    assert nb.wgrad_split(64, 8 * 64 * 128) == (86, 768)
    assert nb.wgrad_split(16, 8 * 128 * 256) == (128, 2048)
    assert nb.dyv_split(16, 8 * 128 * 256) == (1056, 128)
    assert [nb.conv_rows((8, 32, 64, 128), a) for a in (0, 1)] == [128, 128]
    assert [nb.conv_rows((8, 64, 128, 64), a) for a in (0, 1)] == [132, 132]
    assert [nb.conv_rows((8, 128, 256, 16), a) for a in (0, 1)] == [132, 132]
    assert nb.conv_rows((1, 8, 16, 128), 1) == 4


# ----------------------------------------------------------------------
# K8 / K9: the stride-2 ops' sums
# ----------------------------------------------------------------------

def _moments_blocks(y, blocks_of):
    """[sum; sum of squares] per channel, split by blocks_of (n,) -> fold."""
    C = y.shape[-1]
    v = y.reshape(-1, C)
    rows = torch.zeros(int(blocks_of.max()) + 1, 2, C, dtype=v.dtype)
    rows.index_add_(0, blocks_of, torch.stack([v, v * v], 1))
    return fold_rows(rows)


def _dyv_bias(dyv, cc: int):
    """The dyv fold's bias sums: a grid-stride walk over the values, 256 a
    block, channel-fastest -> the first cc channels' fold."""
    C = dyv.shape[-1]
    vals = dyv.reshape(-1)
    n = vals.numel()
    blocks = ew_rows(n)
    rows = torch.zeros(blocks, C, dtype=vals.dtype)
    i = torch.arange(n)
    rows.index_put_(((i // 256) % blocks, i % C), vals, accumulate=True)
    return fold_rows(rows)[:cc]


def _masked_wgrad_rows(small, large, blocks_of):
    """The stride-2 weight gradient per block of small-plane pixels:
    (blocks, cs, cl, 3, 3)."""
    nblk = int(blocks_of.max()) + 1
    flat = blocks_of.reshape(small.shape[:-1])
    return torch.stack([lm.wgrad_s2(small * (flat == b)[..., None], large, 3)
                        for b in range(nblk)])


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 64), (64, 128)])
def test_downsampler_sums_fold_to_the_plain_sums(cin, cout, itemsize):
    rng = np.random.default_rng(cin)
    B, H, W = 2, 32, 64
    cc, ns = cout - cin, B * (H // 2) * (W // 2)
    x = _rn(rng, B, H, W, cin)
    y, dyv = _rn(rng, B, H // 2, W // 2, cout), _rn(rng, B, H // 2, W // 2,
                                                     cout)
    p = torch.arange(ns)
    fwd_blocks = ((p // 256) % ew_rows(ns) if cin == 3 else p // lm.S2_ROWS)
    _close(_moments_blocks(y, fwd_blocks), nb._moments(y))
    _close(_dyv_bias(dyv, cc), dyv[..., :cc].sum(nb._SUM))
    if cin == 3:  # 16 threads a small pixel, grid-stride
        wg_blocks = (p // 16) % ew_rows(16 * ns)
    else:
        wg_blocks = p // lm.s2_wgrad_split(ns, itemsize, 64, cin)[1]
    got = fold_rows(_masked_wgrad_rows(dyv[..., :cc], x, wg_blocks))
    _close(got, lm.wgrad_s2(dyv[..., :cc], x, 3))


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout", [(128, 64), (64, 16)])
def test_upsampler_sums_fold_to_the_plain_sums(cin, cout, itemsize):
    rng = np.random.default_rng(cin + cout)
    B, H, W = 2, 16, 32
    n = B * H * W
    x = _rn(rng, B, H, W, cin)
    y, dyv = (_rn(rng, B, 2 * H, 2 * W, cout) for _ in range(2))
    # the forward's blocks: 64 small pixels of one output parity (phase)
    b_, Y, X = torch.meshgrid(torch.arange(B), torch.arange(2 * H),
                              torch.arange(2 * W), indexing="ij")
    small = ((b_ * H + Y // 2) * W + X // 2).reshape(-1)
    phase = (2 * (Y % 2) + X % 2).reshape(-1)
    gx = cdiv(n, lm.S2_ROWS)
    _close(_moments_blocks(y, phase * gx + small // lm.S2_ROWS),
           nb._moments(y))
    _close(_dyv_bias(dyv, cout), dyv.sum(nb._SUM))
    per = lm.s2_wgrad_split(n, itemsize, cin, cout)[1]
    got = fold_rows(_masked_wgrad_rows(x, dyv, torch.arange(n) // per))
    _close(got, lm.wgrad_s2(x, dyv, 3))


def test_s2_partitions_keep_the_tiles_waves():
    """At the step's shapes the stride-2 weight gradients keep one wave of
    the H100 (a ninth of 132 SMs times each tile's blocks an SM)."""
    assert lm.s2_wgrad_split(8 * 64 * 128, 4, 64, 16) == (86, 768)
    assert lm.s2_wgrad_split(8 * 32 * 64, 4, 64, 64) == (57, 288)
    assert lm.s2_wgrad_split(8 * 32 * 64, 4, 128, 64) == (29, 576)
    assert lm.s2_wgrad_split(8 * 32 * 64, 2, 128, 64) == (57, 288)


# ----------------------------------------------------------------------
# The wrappers: a partials scratch, no zero fill
# ----------------------------------------------------------------------

@pytest.fixture
def stubs(monkeypatch):
    s = Stubs()
    s.allocated, s.zeroed = [], []
    empty, zeros = torch.empty, torch.zeros

    def watched_empty(*shape, **kw):
        t = empty(*shape, **kw)
        s.allocated.append(tuple(t.shape))
        return t

    def watched_zeros(*shape, **kw):
        t = zeros(*shape, **kw)
        s.zeroed.append(tuple(t.shape))
        return t
    for mod in (nb, lm, pc):
        for name in ("kernel", "launch", "check_cuda"):
            monkeypatch.setattr(mod, name, getattr(s, name))
    for f in (nb.nb_half_a, nb.nb_half_b, lm.downsampler_op, lm.lane_maps_op,
              pc.packed_conv_act, pc.packed_conv):
        monkeypatch.setattr(f, "launches", 0)
        monkeypatch.setattr(f, "bwd_launches", 0)
    monkeypatch.setattr(torch, "empty", watched_empty)
    monkeypatch.setattr(torch, "zeros", watched_zeros)
    return s


def _asked(stubs, part_at: int, floats: int):
    """The one launch's partials: its pointer given, its floats the last
    int, and a scratch of that many floats allocated."""
    [(_, _, args)] = stubs.calls
    assert args[part_at] is not None and args[-1] == floats
    assert (floats,) in stubs.allocated


def _t(*shape, dtype=F32):
    return torch.ones(*shape, dtype=dtype)  # not a zero fill the stubs see


@pytest.mark.parametrize("dt", [F32, BF16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("half", ["a", "b"])
def test_half_block_wrappers_ask_for_partials(stubs, half, dt):
    B, H, W, C, d = 2, 24, 40, 64, 2
    x = _t(B, H, W, C, dtype=dt)
    k, b = _t(3, C, C), _t(C)
    mul = add = None if half == "a" else _t(C)
    stubs.zeroed.clear()
    nb._half_fwd_cuda(x, mul, add, k, b, k, b, d)
    _asked(stubs, 9, nb.fwd_partials(x.shape, dt))
    assert stubs.zeroed == []
    stubs.calls.clear()
    nb.half_bwd_kernel(x, mul, add, x, x, x, _t(2, C), k, k, d)
    _asked(stubs, 16, nb.bwd_partials(x.shape, half == "b", dt))
    assert stubs.zeroed == []


@pytest.mark.parametrize("dt", [F32, BF16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 64), (64, 128)])
def test_downsampler_wrappers_ask_for_partials(stubs, dt, cin, cout):
    B, H, W = 2, 8, 12
    x, y = _t(B, H, W, cin, dtype=dt), _t(B, H // 2, W // 2, cout, dtype=dt)
    wt, bias = _t(cout - cin, cin, 3, 3), _t(cout - cin)
    es = torch.finfo(dt).bits // 8
    lm._downsampler_fwd_cuda(x, wt, bias)
    _asked(stubs, 5, lm.downsampler_partials(B, H, W, cin, cout, es, False))
    stubs.calls.clear()
    lm.downsampler_bwd_kernel(x, y, y, _t(2, cout), wt)
    _asked(stubs, 9, lm.downsampler_partials(B, H, W, cin, cout, es, True))
    assert stubs.zeroed == []


@pytest.mark.parametrize("dt", [F32, BF16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout", [(128, 64), (64, 16)])
def test_lane_maps_wrappers_ask_for_partials(stubs, dt, cin, cout):
    B, H, W = 2, 4, 6
    x = _t(B, H, W, cin, dtype=dt)
    y = _t(B, 2 * H, 2 * W, cout, dtype=dt)
    wt, bias = _t(cin, cout, 3, 3), _t(cout)
    es = torch.finfo(dt).bits // 8
    lm._lane_maps_fwd_cuda(x, wt, bias, 3, dt, True)
    _asked(stubs, 5, lm.lane_maps_partials(B, H, W, cin, cout, es, False))
    stubs.calls.clear()
    lm.lane_maps_bwd_kernel(x, y, y, _t(2, cout), wt, 3)
    _asked(stubs, 9, lm.lane_maps_partials(B, H, W, cin, cout, es, True))
    assert stubs.zeroed == []


def test_k11_float32_weight_gradient_asks_for_partials(stubs):
    """K11 in float32: dk and db from the fold, no zero fill; packed_conv
    (no bias) asks for dk's partials alone (the bf16 wrappers:
    `tests/test_torch_fixed_order_bf16.py`)."""
    B, H, W, C = 2, 8, 8, 64
    x, k = _t(B, H, W, C), _t(3, C, C)
    pc.packed_conv_bwd_kernel(x, x, x, k, "h", 1, True)
    floats = pc.bwd_partials(x.shape, "h", F32)
    _asked(stubs, 8, floats)
    assert floats == (nb.dyv_split(C, B * H * W)[0] * C
                      + nb.wgrad_split(C, B * H * W)[0] * 3 * C * C
                      + nb.f32_planes(C))
    stubs.calls.clear()
    pc.packed_conv_bwd_kernel(x, None, x, k, "w", 1, False, bias=False)
    _asked(stubs, 8, nb.wgrad_split(C, B * H * W)[0] * 3 * C * C
           + nb.f32_planes(C))
    assert stubs.zeroed == []


# ----------------------------------------------------------------------
# The step: cuDNN's deterministic algorithms on the fused-maps path
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fused_blocks,fused_maps,packed,want", [
    (True, None, True, True), (False, True, True, True),
    (True, False, True, False), (False, None, True, False),
    (True, None, False, False)])
def test_step_runs_cudnn_deterministic_where_only_the_heads_use_it(
        monkeypatch, fused_blocks, fused_maps, packed, want):
    """The packed step with fused maps (the default), whose only cuDNN
    convolutions are the heads, runs its forward and backward with
    `torch.backends.cudnn.deterministic` on, and restores the flag after;
    the other paths leave it as it is."""
    from lanedetection_end2end_tpu_torch.config import train_sh_config
    from lanedetection_end2end_tpu_torch.train import steps
    seen = []
    model = torch.nn.Linear(2, 1)

    def fake_loss_fn(*args, **kw):
        def loss_fn(batch, generator=None):
            seen.append(torch.backends.cudnn.deterministic)
            loss = model(torch.ones(1, 2)).sum()
            return loss, {"loss": loss.detach()}, {}
        return loss_fn
    monkeypatch.setattr(steps, "make_loss_fn", fake_loss_fn)
    monkeypatch.setattr(steps, "resolve_packed", lambda *a: packed)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    cfg = train_sh_config(resize=32, reg_ls=1.0)
    step = steps.make_train_step(model, cfg, torch.optim.SGD(
        model.parameters(), lr=0.1), device="cpu", fused_blocks=fused_blocks,
        fused_maps=fused_maps)
    step({}, None)
    assert seen == [want]
    assert torch.backends.cudnn.deterministic is False
