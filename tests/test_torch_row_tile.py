"""The serving kernels' tiles (`csrc/nb1d.cuh`, `csrc/downsampler.cuh`,
`csrc/upsampler.cuh`) in plain PyTorch on the CPU, and their wrappers with
the launches stubbed.

- The NB1D row tile: a tile holds MT = 8192 / C pixels. Rows of W <= MT
  pixels: a tile owns R = MT / W whole rows; each pass runs its 3x1
  convolution for the tile's rows (reading the plane's rows h - d, h, h +
  d), rounds to bf16 into the staged rows, then runs the 1x3 convolution
  on the tile's staged rows alone (zero beyond them: the halo). Wider
  rows: a tile owns a segment of MT columns of one row (the last one
  partial where MT does not divide W), and its staged row also holds the
  3x1 convolution of the d halo columns on each side of the segment
  (computed, zero only off the plane). That order, `rowtile_plain`,
  equals `ops/nb1d.py::nb1d_plain` bit for bit at d = 1, 2 and 16 (16 >=
  H, W among them), at W = 2 MT and at W = MT + 16 (a partial segment),
  and holds to JAX's `_nb1d_body` (`nb1d_fused` in interpret mode) at
  tests/test_torch_nb1d.py's bar, 1e-2 of max|JAX|.
- The stride-2 tiles' weights: `pack_encoder` / `pack_decoder` lay them
  out once, taps first ((3, 3, cin, cout): the (9, CK, N) order the
  tiles read); read back from the flat buffer at the table's offsets they
  rebuild the state_dict weights exactly.
- The stride-2 tiles' geometry: the downsampler as the implicit GEMM of
  ConvGeo (A row (p, tap) = x at (2h + ky - 1, 2w + kx - 1)) with the pool
  channels from the same windows, and the upsampler as PhaseGeo's four
  parity phases (`ops/tf32x3.py::convt_s2_phases`, the kernels' tap
  order): in float64 they equal `F.conv2d` / `F.conv_transpose2d` to
  1e-12, and after the serving epilogue (BatchNorm folded, relu, one bf16
  rounding) they equal `downsampler_plain` / `upsampler_plain` within one
  bf16 rounding step, 2^-8 of max|plain| (the plain versions sum in f32).
- The wrappers of K1, the chain, K2 and K3 on meta tensors with `kernel`,
  `launch` and `check_cuda` stubbed: each asks for its C entry with its
  signature's argument count, also on rows wider than a tile, and refuses
  before any launch the planes the tiles do not take (other channel
  counts, chains of other lengths)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lanedetection_end2end_tpu.config import train_sh_config as jax_config
from lanedetection_end2end_tpu.models import LaneNet as JaxLaneNet
from lanedetection_end2end_tpu.ops.pallas_nb1d import nb1d_fused
from lanedetection_end2end_tpu.ops.pallas_nb1d import pack_nb1d as jax_pack
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.models import fused_graph as fg
from lanedetection_end2end_tpu_torch.models.lanenet import make_fitter
from lanedetection_end2end_tpu_torch.models.port import (
    nb1d_state, state_dict_from_variables)
from lanedetection_end2end_tpu_torch.ops import backbone as bb
from lanedetection_end2end_tpu_torch.ops import backbone_fused as bf
from lanedetection_end2end_tpu_torch.ops import nb1d as k1
from lanedetection_end2end_tpu_torch.ops.nb1d import (
    _conv3, nb1d_plain, pack_chain, pack_nb1d)
from lanedetection_end2end_tpu_torch.ops.tf32x3 import convt_s2_phases
from test_torch_engine import _randomize_bn
from test_torch_fused_backbone import Stubs
from test_torch_nb1d import _block
from test_torch_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
ONE_STEP = 2.0 ** -8  # one bf16 rounding step, relative


# ----------------------------------------------------------------------
# The NB1D row tile
# ----------------------------------------------------------------------

def _rnd(y):
    return y.to(BF16).float()


# pixels a tile at C channels (csrc/nb1d.cuh, Cfg<C>::MT = 8192 / C)
MT = {16: 256, 64: 128, 128: 64}


def _tile_pass(inp, w0, b0, w1, mul, add, d, mt, res=None):
    """One pass of the row tile over the plane, mt pixels a tile: conv0
    (3x1) of the tile's pixels, which read the whole plane, +b0, relu, bf16
    (the staged rows); conv1 (1x3) of the tile's staged rows alone (every
    other pixel zero, so nothing outside the tile reaches them), * mul +
    add (+ res), relu. A tile owns R = mt / W whole rows, or, where W > mt,
    the columns c0 .. c0 + mt - 1 of one row, its staged row carrying conv0
    of the halo columns c0 - hd .. c0 - 1 and c0 + mt .. c0 + mt + hd - 1
    (hd = d where d < W) that lie on the plane. Returns f32 (the caller
    rounds). Each convolution runs at the plane's shape, as
    `nb1d_plain`'s do: the CPU's convolution sums in an order that can
    change with the shape, not with the values."""
    B, H, W, C = inp.shape
    out = torch.empty(B, H, W, C)
    t = _rnd(torch.relu(_conv3(inp.float(), w0, 0, d) + b0))

    def conv1(b, rows, c0, c1, keep):
        staged = torch.zeros_like(t)
        staged[b, rows, keep] = t[b, rows, keep]
        y = _conv3(staged, w1, 1, d)[b, rows, c0:c1] * mul + add
        if res is not None:
            y = y + res[b, rows, c0:c1]
        out[b, rows, c0:c1] = torch.relu(y)

    for b in range(B):
        if W <= mt:
            R = mt // W
            for h0 in range(0, H, R):
                rows = slice(h0, min(h0 + R, H))
                conv1(b, rows, 0, W, slice(0, W))
            continue
        hd = d if d < W else 0
        for h in range(H):
            for c0 in range(0, W, mt):
                c1 = min(c0 + mt, W)
                conv1(b, slice(h, h + 1), c0, c1,
                      slice(max(c0 - hd, 0), min(c0 + mt + hd, W)))
    return out


def rowtile_plain(x, p, mt):
    """The NB1D block in the row tile's order: pass A (the d = 1 pair) into
    the plane `mid`, pass B (the dilated pair and the residual)."""
    w, v, d = p["w"], p["vec"], p["dilation"]
    mid = _rnd(_tile_pass(x, w[0], v[0], w[1], v[1], v[2], 1, mt))
    y = _tile_pass(mid, w[2], v[3], w[3], v[4], v[5], d, mt, res=x.float())
    return y.to(BF16)


# (C, d, H, W): whole rows, R = MT / W a tile (d = 16 >= H, W leaves only
# the centre taps), then rows wider than a tile, W = 2 MT and W = MT + 16
# (a partial last segment), at d = 1, 2 and 16
ROW_CASES = [(16, 1, 16, 32), (64, 2, 8, 16), (128, 2, 8, 16),
             (128, 16, 8, 16), (16, 16, 8, 16),
             (128, 1, 4, 128), (128, 2, 4, 80), (128, 16, 4, 128),
             (64, 2, 4, 256), (64, 16, 4, 144), (16, 1, 4, 272),
             (16, 16, 2, 512)]


def _row_id(c, d, h, w):
    tile = f"R{MT[c] // w}" if w <= MT[c] else f"seg{MT[c]}"
    return f"C{c}-d{d}-{h}x{w}-{tile}"


@pytest.fixture(scope="module", params=ROW_CASES,
                ids=[_row_id(*case) for case in ROW_CASES])
def row_case(request):
    C, d, H, W = request.param
    x, params, stats = _block(C, d, H, W, seed=C + d + 7)
    p = pack_nb1d(nb1d_state(params, stats, "blk"), "blk", d)
    xt = torch.from_numpy(x).to(BF16)
    return {"x": x, "xt": xt, "p": p, "params": params, "stats": stats,
            "d": d, "got": rowtile_plain(xt, p, MT[C])}


def test_row_tile_order_equals_nb1d_plain(row_case):
    want = nb1d_plain(row_case["xt"], row_case["p"])
    assert torch.equal(row_case["got"], want)


def test_row_tile_order_matches_jax_body(row_case):
    d = row_case["d"]
    want = np.asarray(nb1d_fused(
        jnp.asarray(row_case["x"], jnp.bfloat16),
        jax_pack(row_case["params"], row_case["stats"], d), dilation=d,
        interpret=True).astype(jnp.float32))
    got = row_case["got"].float().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-2


# ----------------------------------------------------------------------
# The stride-2 tiles: weights and geometry
# ----------------------------------------------------------------------

RESIZE, BATCH = 64, 2


@pytest.fixture(scope="module")
def packed():
    rng = np.random.default_rng(3)
    jcfg = jax_config(resize=RESIZE, batch_size=BATCH, reg_ls=1.0)
    v = _randomize_bn(JaxLaneNet(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(3)), rng)
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0)
    sd = state_dict_from_variables(v)
    return {"sd": sd, "enc": fg.pack_encoder(sd),
            "dec": fg.pack_decoder(sd, cfg, make_fitter(cfg, "cpu"))}


def _flat_weights(packed, part, i):
    stages = bf.ENC_STAGES if part == "enc" else bf.DEC_STAGES
    p = bf.stage(packed[part], stages[i])
    wo = list(packed[part]["table"])[i]
    return packed[part]["wbuf"][wo:wo + p["w"].numel()].view(p["w"].shape)


# stage index, state_dict prefix, (weight layout -> torch parameter layout)
S2_LAYOUTS = [
    ("enc", 0, "net.encoder.initial_block.conv", (3, 2, 0, 1)),
    ("enc", 1, "net.encoder.layers.0.conv", (3, 2, 0, 1)),
    ("enc", 7, "net.encoder.layers.6.conv", (3, 2, 0, 1)),
    ("dec", 0, "net.decoder.layers.0.conv", (2, 3, 0, 1)),
    ("dec", 3, "net.decoder.layers.3.conv", (2, 3, 0, 1)),
    ("dec", 6, "net.decoder.output_conv", (2, 3, 0, 1)),
]


@pytest.mark.parametrize("part,i,prefix,perm", S2_LAYOUTS,
                         ids=[f"{p}{i}" for p, i, _, _ in S2_LAYOUTS])
def test_stride2_weights_rebuild_the_state_dict(packed, part, i, prefix,
                                                perm):
    """Taps first, (3, 3, cin, cout) (the head (2, 2, cin, C)): the flat
    buffer's segment, permuted back, is the parameter rounded to bf16."""
    w = _flat_weights(packed, part, i)
    want = packed["sd"][f"{prefix}.weight"].to(BF16)
    assert torch.equal(w.permute(*perm), want)


def test_nb1d_weights_rebuild_the_state_dict(packed):
    """An NB1D block's (4, 3, C, C) [conv][tap][ci][co] segment rebuilds
    its four 3-tap convolutions."""
    for part, i, prefix in (("enc", 2, "net.encoder.layers.1"),
                            ("enc", 15, "net.encoder.layers.14"),
                            ("dec", 4, "net.decoder.layers.4")):
        w = _flat_weights(packed, part, i)
        for c, name in enumerate(("conv3x1_1", "conv1x3_1", "conv3x1_2",
                                  "conv1x3_2")):
            want = packed["sd"][f"{prefix}.{name}.weight"].to(BF16)
            got = w[c].permute(2, 1, 0)  # (co, ci, tap)
            got = got.unsqueeze(-1) if c % 2 == 0 else got.unsqueeze(2)
            assert torch.equal(got, want), (part, i, name)


def _convgeo(x, w):
    """The 3x3/s2/p1 convolution as ConvGeo's implicit GEMM in float64: for
    each tap t = 3 ky + kx, the A rows are x at (2h + ky - 1, 2w + kx - 1)
    (zero off the plane), times the tap's (cin, cc) weights."""
    xd = F.pad(x.double(), (0, 0, 1, 0, 1, 0))  # a zero row and column before
    B, Hp, Wp, _ = xd.shape
    Hs, Ws = (Hp - 1) // 2, (Wp - 1) // 2
    acc = 0
    for ky in range(3):
        for kx in range(3):
            acc = acc + (xd[:, ky:ky + 2 * Hs:2, kx:kx + 2 * Ws:2]
                         @ w[ky, kx].double())
    return acc


def _pool(x):
    B, H, W, C = x.shape
    return x.float().reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def _within_a_step(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err <= ONE_STEP * want.float().abs().max().item()


@pytest.mark.parametrize("stage_i", [0, 1, 7], ids=["3-16", "16-64",
                                                    "64-128"])
def test_convgeo_downsampler_equals_plain(packed, stage_i):
    p = bf.stage(packed["enc"], bf.ENC_STAGES[stage_i])
    cin = p["w"].shape[2]
    H, W = {3: (32, 64), 16: (16, 32), 64: (8, 16)}[cin]
    g = torch.Generator().manual_seed(cin)
    x = torch.randn(BATCH, H, W, cin, generator=g).to(BF16)
    conv = _convgeo(x, p["w"])
    ref = F.conv2d(x.double().permute(0, 3, 1, 2),
                   p["w"].double().permute(3, 2, 0, 1), stride=2, padding=1)
    assert torch.allclose(conv, ref.permute(0, 2, 3, 1), rtol=0, atol=1e-12)
    y = torch.cat([conv.float(), _pool(x)], dim=-1)
    got = torch.relu(y * p["mul"] + p["add"]).to(BF16)
    assert _within_a_step(got, bb.downsampler_plain(x, p))


@pytest.mark.parametrize("stage_i", [0, 3], ids=["128-64", "64-16"])
def test_phasegeo_upsampler_equals_plain(packed, stage_i):
    p = bf.stage(packed["dec"], bf.DEC_STAGES[stage_i])
    cin = p["w"].shape[2]
    g = torch.Generator().manual_seed(cin)
    x = torch.randn(BATCH, 8, 16, cin, generator=g).to(BF16)
    w_param = p["w"].permute(2, 3, 0, 1)  # (cin, cout, 3, 3), unflipped
    phases = convt_s2_phases(x, w_param, 3)
    ref = F.conv_transpose2d(x.double().permute(0, 3, 1, 2),
                             w_param.double(), stride=2, padding=1,
                             output_padding=1)
    assert torch.allclose(phases, ref.permute(0, 2, 3, 1), rtol=0,
                          atol=1e-12)
    got = torch.relu(phases.float() * p["mul"] + p["add"]).to(BF16)
    assert _within_a_step(got, bb.upsampler_plain(x, p))


# ----------------------------------------------------------------------
# The wrappers of K1, the chain, K2 and K3, launches stubbed
# ----------------------------------------------------------------------

@pytest.fixture
def stubs(monkeypatch):
    s = Stubs()
    for mod in (k1, bb):
        for name in ("kernel", "launch", "check_cuda"):
            monkeypatch.setattr(mod, name, getattr(s, name))
    for f in (k1.nb1d, k1.nb1d_chain, bb.downsampler, bb.upsampler):
        monkeypatch.setattr(f, "launches", 0)
    return s


def _meta(*shape):
    return torch.empty(*shape, dtype=BF16, device="meta")


def _nb_consts(C, d=1):
    return {"w": _meta(4, 3, C, C), "vec": torch.empty(6, C, device="meta"),
            "dilation": d}


def _s2_consts(cin, cout, down):
    cw = cout - cin if down else cout
    return {"w": _meta(3, 3, cin, cw),
            "mul": torch.empty(cout, device="meta"),
            "add": torch.empty(cout, device="meta")}


def test_nb1d_wrappers_ask_for_their_entries(stubs):
    x = _meta(2, 8, 128, 64)
    out = k1.nb1d(x, _nb_consts(64, 2))
    chain = pack_chain([_nb_consts(64, d) for d in (1, 2)])
    k1.nb1d_chain(x, chain)
    assert [(n, s) for n, s, _ in stubs.calls] == [
        ("nb1d", "ld_nb1d"), ("nb1d_chain", "ld_nb1d_chain")]
    # K1: x, w, vec, mid, out, B, H, W, C, d
    assert stubs.calls[0][2][-5:] == (2, 8, 128, 64, 2)
    # chain: x, w, vec, dilations, n, mid, a, out, B, H, W, C
    assert stubs.calls[1][2][4] == 2
    assert stubs.calls[1][2][-4:] == (2, 8, 128, 64)
    assert out.shape == x.shape
    assert k1.nb1d.launches == 1 and k1.nb1d_chain.launches == 1


def test_stride2_wrappers_ask_for_their_entries(stubs):
    y = bb.downsampler(_meta(2, 16, 32, 16), _s2_consts(16, 64, True))
    z = bb.upsampler(_meta(2, 8, 16, 128), _s2_consts(128, 64, False))
    assert [(n, s) for n, s, _ in stubs.calls] == [
        ("downsampler", "ld_downsampler"), ("upsampler", "ld_upsampler")]
    assert stubs.calls[0][2][-5:] == (2, 16, 32, 16, 64)
    assert stubs.calls[1][2][-5:] == (2, 8, 16, 128, 64)
    assert y.shape == (2, 8, 16, 64) and z.shape == (2, 16, 32, 64)


# rows wider than a tile (MT = 8192 / C pixels): segments of a row since
# the column-split tile, so the wrappers launch, with the plane's own
# shape, where they refused before
WIDE = {
    "nb1d rows wider than a tile": (
        lambda: k1.nb1d(_meta(1, 4, 2 * MT[128], 128), _nb_consts(128)),
        ("nb1d", "ld_nb1d"), (1, 4, 2 * MT[128], 128)),
    "chain rows wider than a tile": (
        lambda: k1.nb1d_chain(_meta(1, 4, 2 * MT[16], 16),
                              pack_chain([_nb_consts(16)])),
        ("nb1d_chain", "ld_nb1d_chain"), (1, 4, 2 * MT[16], 16)),
    "nb1d partial segment": (
        lambda: k1.nb1d(_meta(1, 4, MT[64] + 16, 64), _nb_consts(64, 16)),
        ("nb1d", "ld_nb1d"), (1, 4, MT[64] + 16, 64)),
}


@pytest.mark.parametrize("case", sorted(WIDE))
def test_wrappers_take_rows_wider_than_a_tile(stubs, case):
    call, entry, shape = WIDE[case]
    out = call()
    assert [(n, s) for n, s, _ in stubs.calls] == [entry]
    args = stubs.calls[0][2]
    # B, H, W, C right after the planes (K1: before d)
    assert shape == (args[-5:-1] if entry[0] == "nb1d" else args[-4:])
    assert out.shape == shape


REFUSED = {
    "nb1d 32 channels": (lambda: k1.nb1d(_meta(1, 4, 16, 32),
                                         _nb_consts(32))),
    "chain 32 channels": (
        lambda: k1.nb1d_chain(_meta(1, 4, 16, 32),
                              pack_chain([_nb_consts(32)]))),
    "chain of 17 blocks": (
        lambda: k1.nb1d_chain(_meta(1, 4, 2 * MT[16], 16),
                              pack_chain([_nb_consts(16)] * 17))),
    "downsampler 32 -> 64": (
        lambda: bb.downsampler(_meta(1, 8, 8, 32), _s2_consts(32, 64, True))),
    "upsampler 64 -> 32": (
        lambda: bb.upsampler(_meta(1, 8, 8, 64), _s2_consts(64, 32, False))),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrappers_refuse_what_the_tiles_do_not_take(stubs, case):
    with pytest.raises(ValueError):
        REFUSED[case]()
    assert stubs.calls == []
