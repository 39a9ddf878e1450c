"""K10 `head_rowsums_op`'s backward in the order of its kernel
(`csrc/head_rowsums_op.cu`), on the CPU.

The 2x2/s2 transposed convolution has no overlap: input pixel (h, w) alone
makes output pixels (2h + i, 2w + j). So the kernel's backward is one pass
over the input: per input pixel, ddec of its own 2 x 2 quad, dx from that
quad, and its share of dweight; dweight and dbias as partials over tiles
of `HEAD_BWD_TILE` input pixels (x^T T(ddec), and the f32 ddec), then the
tiles' partials added in `hr_sum_kernel`'s fixed order: lane l of a warp
adds partials l, l + 32, ... in turn, then the 32 lanes fold by halves.
`quads_bwd` writes that formulation, tiling and fold in plain PyTorch.
Inside a tile it sums by matmul: the kernel's fused multiply-adds in
pixel order have no bit-exact counterpart on the CPU, so what is checked
is the formulation and the tiles' sum, not the kernel's float32 rounding
(which `chip_smoke.py` holds on the card, bit for bit across launches):

- in float64 it equals `head_rowsums_bwd_plain` (a transposed convolution,
  its weight gradient and a sum) to 1e-12 of max|plain|, with top rows
  masked and the fitter's column coordinate;
- in float32 and in bf16 it holds to the gradients of the JAX package's
  `head_rowsums_op` (`interpret=True`) at tests/test_torch_lanemaps.py's
  bars: 2e-3 of max|g| in float32 (the JAX package's own,
  tests/test_fused_blocks.py), 8e-2 in bf16 (its bar for the bf16 head
  tail, whose (dec^2)^2 quadruples the operands' rounding).

Then the CUDA wrapper on meta tensors with `kernel`, `launch` and
`check_cuda` stubbed: it asks for its C entry with the new argument count
(no tap copies, no gradient plane), allocates no (B, H, W, C) plane and
refuses more than 8 lanes or another input width before any launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.ops import packed_graph as pg
from lanedetection_end2end_tpu.ops import pallas_lanemaps as jlm
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.models.lanenet import (
    make_fitter, zero_rows)
from lanedetection_end2end_tpu_torch.models.port import conv_transpose_state
from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
from test_torch_f32_fused import Stubs

RESIZE, B, CIN, C = 32, 2, 16, 4
F64 = torch.float64


def quads_bwd(x, dS, weight, bias, xs, zero, tile=lm.HEAD_BWD_TILE):
    """K10's backward in its kernel's order: x (B, H/2, W/2, cin), dS (B,
    H, 2C), the parameter weight (cin, C, 2, 2) -> (dx, dweight, dbias).
    Sums in float64 for a float64 plane, else f32; dp and dx rounded to
    x's dtype where the kernel rounds them."""
    acc = F64 if x.dtype == F64 else torch.float32
    rnd = lambda t: t.to(x.dtype).to(acc)
    Bn, Hh, Wh, cin = x.shape
    Cn = weight.shape[1]
    K = rnd(weight)                                    # (cin, C, i, j)
    xf = x.to(acc)
    # each input pixel's quad: dec[b, h, w, i, j, c]
    dec = bias.to(acc) + torch.einsum("bhwk,kcij->bhwijc", xf, K)
    g = dS.to(acc).reshape(Bn, Hh, 2, 2 * Cn)          # rows 2h + i
    g0 = g[..., :Cn][:, :, None, :, None]              # (B, Hh, 1, 2, 1, C)
    g1 = g[..., Cn:][:, :, None, :, None]
    xcol = xs.to(acc).reshape(Wh, 2)[None, None, :, None, :, None]
    ddec = 4.0 * dec * dec * dec * (g0 + xcol * g1)
    live = (2 * torch.arange(Hh)[:, None] + torch.arange(2)) >= zero
    ddec = ddec * live[None, :, None, :, None, None].to(acc)
    dp = rnd(ddec)
    dx = torch.einsum("bhwijc,kcij->bhwk", dp, K).to(x.dtype)
    # per tile of `tile` pixels: X^T D and the sum of ddec; then the fold
    X = xf.reshape(-1, cin)
    D = dp.reshape(-1, 4 * Cn)                         # (i, j, c)
    Dd = ddec.reshape(-1, 4, Cn)
    tiles = range(0, X.shape[0], tile)
    dw = lane_fold([X[t0:t0 + tile].T @ D[t0:t0 + tile] for t0 in tiles])
    dbias = lane_fold([Dd[t0:t0 + tile].sum((0, 1)) for t0 in tiles])
    dweight = dw.reshape(cin, 2, 2, Cn).permute(0, 3, 1, 2)
    return dx, dweight, dbias


def lane_fold(parts):
    """`hr_sum_kernel`'s sum of the tiles' partials: lane l adds partials
    l, l + 32, ... in turn, then lane l adds lane l + off's sum for off =
    16, 8, 4, 2, 1 (__shfl_down_sync); lane 0 holds the result."""
    lanes = [torch.zeros_like(parts[0]) for _ in range(32)]
    for k, part in enumerate(parts):
        lanes[k % 32] = lanes[k % 32] + part
    off = 16
    while off:
        for lane in range(off):
            lanes[lane] = lanes[lane] + lanes[lane + off]
        off //= 2
    return lanes[0]


def _case(seed, dtype):
    """A seeded head tail at resize 32 (x (2, 16, 32, 16)): the parameter
    and bias in f32 values, dS, the fitter's xs and the config's top-row
    mask."""
    rng = np.random.default_rng(seed)
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0)
    H, W = RESIZE, 2 * RESIZE
    f = lambda *s, scale=1.0: torch.from_numpy(
        rng.normal(0, scale, s).astype(np.float32))
    x = f(B, H // 2, W // 2, CIN).to(dtype)
    return {"x": x, "dS": f(B, H, 2 * C).to(dtype if dtype == F64 else
                                            torch.float32),
            "weight": f(CIN, C, 2, 2, scale=0.3).to(
                F64 if dtype == F64 else torch.float32),
            "bias": f(C, scale=0.1).to(F64 if dtype == F64 else
                                       torch.float32),
            "xs": make_fitter(cfg, "cpu").sep_xs.float(),
            "zero": zero_rows(cfg)}


@pytest.mark.parametrize("seed", [0, 1])
def test_quads_equal_the_plain_backward_in_float64(seed):
    c = _case(seed, F64)
    assert c["zero"] > 0
    args = (c["x"], c["dS"], c["weight"], c["bias"], c["xs"], c["zero"])
    got = quads_bwd(*args)
    want = lm.head_rowsums_bwd_plain(*args)
    for name, a, b in zip(("dx", "dweight", "dbias"), got, want):
        assert a.dtype == b.dtype == F64, name
        assert a.shape == b.shape, name
        err = (a - b).abs().max() / b.abs().max()
        assert err < 1e-12, (name, float(err))
    # the masked rows' gradient reaches nothing: dx of the top input rows
    # that feed only masked output rows is zero
    top = c["zero"] // 2
    assert torch.all(got[0][:, :top] == 0)


def test_tile_partials_do_not_depend_on_the_tile():
    """The fixed-order sum over tiles of x^T dp: any tile size gives the
    same dweight up to float64 rounding (the kernel's is HEAD_BWD_TILE)."""
    c = _case(2, F64)
    args = (c["x"], c["dS"], c["weight"], c["bias"], c["xs"], c["zero"])
    a = quads_bwd(*args)[1]
    for tile in (1, 64, 10 ** 6):
        b = quads_bwd(*args, tile=tile)[1]
        assert float((a - b).abs().max() / a.abs().max()) < 1e-13


def _jax_grads(x, dS, params, xs, zero, dtype):
    """Gradients of sum(S * dS) through JAX's `head_rowsums_op` with the
    constants `LaneNet.apply_packed` builds for it (as
    tests/test_torch_lanemaps.py calls it), planes in `dtype`."""
    Hh, Wh = x.shape[1:3]
    H, W = 2 * Hh, 2 * Wh
    w0 = dS[:, :, :C].transpose(0, 2, 1)
    w1 = dS[:, :, C:].transpose(0, 2, 1)

    def f(p, xx):
        plan, maps, btile, in_lanes, out_lanes = pg.head_plan_maps(p, CIN, C)
        plane = xx.reshape(B, Hh, -1).astype(dtype)
        L2 = (plane.shape[-1] // in_lanes) * 128
        sel = jnp.zeros((128, 128), jnp.float32).at[:, :C].set(
            jnp.asarray(pg._chan_select(C)))
        red = jnp.asarray(np.tile(np.eye(128, dtype=np.float32),
                                  (L2 // 128, 1)))
        s = jlm.head_rowsums_op(plane, maps, btile,
                                jnp.asarray(np.repeat(xs, C)[None, :]), sel,
                                red, plan, in_lanes, zero)
        S0 = s[:, :, :C].transpose(0, 2, 1)
        S1 = s[:, :, 128:128 + C].transpose(0, 2, 1)
        return jnp.sum(S0 * w0) + jnp.sum(S1 * w1)
    gp, gx = jax.grad(f, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    return np.asarray(gx, np.float32), np.asarray(gp["kernel"]), np.asarray(
        gp["bias"])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3),
                                       (torch.bfloat16, 8e-2)],
                         ids=["float32", "bfloat16"])
def test_quads_match_jax_head_rowsums_op(dtype, tol):
    rng = np.random.default_rng(5)
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0)
    H, W = RESIZE, 2 * RESIZE
    zero = zero_rows(cfg)
    xs = make_fitter(cfg, "cpu").sep_xs.float().numpy()
    x = rng.normal(0, 1, (B, H // 2, W // 2, CIN)).astype(np.float32)
    params = {"kernel": rng.normal(0, 0.2, (2, 2, CIN, C)).astype(np.float32),
              "bias": rng.normal(0, 0.1, C).astype(np.float32)}
    dS = rng.normal(0, 1, (B, H, 2 * C)).astype(np.float32)
    conv = torch.nn.ConvTranspose2d(CIN, C, 2, stride=2)
    conv.load_state_dict({k[len("b."):]: v for k, v in
                          conv_transpose_state(params, "b").items()})
    xt = torch.from_numpy(x).to(dtype)
    dx, dweight, dbias = quads_bwd(xt, torch.from_numpy(dS),
                                   conv.weight.detach(), conv.bias.detach(),
                                   torch.from_numpy(xs), zero)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = np.asarray(jnp.asarray(x).astype(jdt).astype(jnp.float32))
    gx, gk, gb = _jax_grads(jx, dS, params, xs, zero, jdt)
    got = {"x": dx.float().numpy(), "bias": dbias.numpy(),
           # the parameter (cin, C, 2, 2) in the flax kernel layout
           "kernel": dweight.numpy().transpose(2, 3, 0, 1)[::-1, ::-1]}
    want = {"x": gx, "kernel": gk, "bias": gb}
    gmax = max(float(np.abs(v).max()) for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=tol * gmax, rtol=tol,
                                   err_msg=k)


# ----------------------------------------------------------------------
# The CUDA wrapper, launches stubbed
# ----------------------------------------------------------------------

@pytest.fixture
def stubs(monkeypatch):
    s = Stubs()
    allocated = []
    empty = torch.empty

    def watched_empty(*shape, **kw):
        t = empty(*shape, **kw)
        allocated.append(tuple(t.shape))
        return t
    for name in ("kernel", "launch", "check_cuda"):
        monkeypatch.setattr(lm, name, getattr(s, name))
    monkeypatch.setattr(lm.torch, "empty", watched_empty)
    monkeypatch.setattr(lm.head_rowsums_op, "bwd_launches", 0)
    s.allocated = allocated
    return s


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
def test_backward_wrapper_asks_for_one_pass(stubs, dtype):
    Hh, Wh = 64, 128
    x = _meta(B, Hh, Wh, CIN, dtype=dtype)
    dx, dweight, dbias = lm.head_rowsums_bwd_kernel(
        x, _meta(B, 2 * Hh, 2 * C, dtype=torch.float32),
        _meta(CIN, C, 2, 2, dtype=torch.float32),
        _meta(C, dtype=torch.float32), _meta(2 * Wh, dtype=torch.float32), 3)
    suffix = "" if dtype == torch.bfloat16 else "_f32"
    assert [(n, s) for n, s, _ in stubs.calls] == [
        ("head_rowsums_op", "ld_head_rowsums_op_bwd" + suffix)]
    # x, dS, weight, bias, xs, part, dx, dweight, dbias, B, H, W, cin, C,
    # zero_rows
    args = stubs.calls[0][2]
    assert len(args) == 15
    assert args[-6:] == (B, 2 * Hh, 2 * Wh, CIN, C, 3)
    tiles = -(-B * Hh * Wh // lm.HEAD_BWD_TILE)
    assert (65 * C * tiles,) in stubs.allocated  # the partial sums
    # no gradient plane (B, H, W, C) and no tap copy
    assert (B, 2 * Hh, 2 * Wh, C) not in stubs.allocated
    assert dx.shape == x.shape and dx.dtype == dtype
    assert dweight.shape == (CIN, C, 2, 2) and dbias.shape == (C,)
    assert lm.head_rowsums_op.bwd_launches == 1


REFUSED = {
    "16 lanes": (CIN, 16),
    "3 lanes": (CIN, 3),
    "8 input channels": (8, C),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_backward_wrapper_refuses_before_any_launch(stubs, case):
    cin, lanes = REFUSED[case]
    with pytest.raises(ValueError):
        lm.head_rowsums_bwd_kernel(
            _meta(B, 4, 8, cin), _meta(B, 8, 2 * lanes, dtype=torch.float32),
            _meta(cin, lanes, 2, 2, dtype=torch.float32),
            _meta(lanes, dtype=torch.float32), _meta(16, dtype=torch.float32),
            0)
    assert stubs.calls == [] and lm.head_rowsums_op.bwd_launches == 0
