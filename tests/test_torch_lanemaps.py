"""The port's stride-2 training ops (`ops/lanemaps.py`: `downsampler_op`,
`lane_maps_op`, `head_rowsums_op`) against the JAX package's Pallas
lane-map kernels (`ops/pallas_lanemaps.py`, interpret mode) on the CPU, in
float32.

The same numpy inputs go through both. The JAX side runs its blocks
`downsampler_packed`, `upsampler_packed` and `head_packed` with
`pallas=True` and PACKED_FUSED_MAPS=1, and `head_rowsums_op` with the
constants `LaneNet.apply_packed` builds for it; the port runs the
counterparts of `ops/packed_graph.py` with `fused_maps=True` on modules
loaded with the same weights through `models/port.py`. Shapes and bars are
the JAX package's own for these kernels (tests/test_fused_blocks.py:207-316):
outputs and new BatchNorm statistics atol 2e-4, rtol 1e-3; gradients atol
2e-3 * max|g| over the whole gradient, rtol 2e-3. A conv bias ahead of a
train-mode BatchNorm has true gradient 0, which the absolute part covers.
The port side runs the plain versions, forward and explicit backward,
through the same autograd.Function the card path uses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.ops import packed_graph as pg
from lanedetection_end2end_tpu.ops import pallas_lanemaps as jlm
from lanedetection_end2end_tpu_torch.models.erfnet import (
    DownsamplerBlock, UpsamplerBlock)
from lanedetection_end2end_tpu_torch.models.port import (
    conv_transpose_state, downsampler_state, upsampler_state)
from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
from lanedetection_end2end_tpu_torch.ops import packed_graph as tg
from test_torch_threads import one_torch_thread  # noqa: F401

B = 2
DOWN = [(4, 3, 16), (16, 16, 64), (64, 64, 128)]  # lanes, channels, cout
UP = [(128, 64), (64, 16)]


@pytest.fixture(autouse=True)
def fused_maps_on(monkeypatch):
    monkeypatch.setenv("PACKED_FUSED_MAPS", "1")


def _f32(rng, *shape, scale=1.0):
    return rng.normal(0, scale, shape).astype(np.float32)


def _block_params(rng, kshape, cout):
    params = {"conv": {"kernel": _f32(rng, *kshape, scale=0.2),
                       "bias": _f32(rng, kshape[-1], scale=0.1)},
              "bn": {"scale": rng.uniform(0.8, 1.2, cout).astype(np.float32),
                     "bias": _f32(rng, cout, scale=0.1)}}
    stats = {"bn": {"mean": _f32(rng, cout, scale=0.1),
                    "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}}
    return params, stats


def _load(block, state):
    block.load_state_dict({k[len("b."):]: v for k, v in state.items()})
    return block


def _convt_kernel(w: torch.Tensor) -> np.ndarray:
    """ConvTranspose2d weight (or its gradient) -> the flax kernel layout."""
    return w.detach().numpy().transpose(2, 3, 0, 1)[::-1, ::-1]


def _assert_grads(got: dict, want: dict, tol=2e-3):
    assert set(got) == set(want)
    gmax = max(float(np.abs(v).max()) for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=tol * gmax, rtol=tol,
                                   err_msg=k)


def _block_grads(block, x, convt=False):
    w = block.conv.weight.grad
    return {"x": x.grad.numpy(),
            "kernel": (_convt_kernel(w) if convt
                       else w.numpy().transpose(2, 3, 1, 0)),
            "bias": block.conv.bias.grad.numpy(),
            "scale": block.bn.weight.grad.numpy(),
            "shift": block.bn.bias.grad.numpy()}


def _jax_block(fn, params, stats, x, wy, shape, **kw):
    """(y, new stats, grads) of sum(y * wy) through a JAX packed block."""
    def f(p, xx):
        y, ns = fn(xx.reshape(xx.shape[0], xx.shape[1], -1), p, stats,
                   train=True, pallas=True, **kw)
        y = y.reshape(shape)
        return jnp.sum(y * wy), (y, ns)
    (_, (y, ns)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                                has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    grads = {"x": np.asarray(gx), "kernel": np.asarray(gp["conv"]["kernel"]),
             "bias": np.asarray(gp["conv"]["bias"]),
             "scale": np.asarray(gp["bn"]["scale"]),
             "shift": np.asarray(gp["bn"]["bias"])}
    return np.asarray(y), ns, grads


def _assert_stats(bn, ns):
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(ns["bn"]["mean"]), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(ns["bn"]["var"]), atol=2e-4,
                               rtol=1e-3)


def _down_case(rng, lanes, cin, cout, ties=False):
    H, W = 8, 512 // lanes
    x = np.maximum(_f32(rng, B, H, W, lanes), 0) if ties else _f32(
        rng, B, H, W, lanes)
    if ties:  # exact ties between two non-zero maxima, (1, 0) and (0, 1)
        x[:, 0::4, 0::4] = 0.5
        x[:, 1::4, 1::4] = 0.5
        x[:, 0::4, 1::4] = 3.0
        x[:, 1::4, 0::4] = 3.0
    x[..., cin:] = 0.0  # the padded RGB lane is zero
    params, stats = _block_params(rng, (3, 3, cin, cout - cin), cout)
    wy = _f32(rng, B, H // 2, W // 2, cout)
    return x, params, stats, wy


def _run_down(x, params, stats, wy, lanes, cin, cout, fused_maps=True):
    block = _load(DownsamplerBlock(cin, cout),
                  downsampler_state(params, stats, "b"))
    t = torch.from_numpy(x[..., :cin].copy()).requires_grad_()
    y = tg.downsampler_train(t, block, train=True, fused_maps=fused_maps)
    (y * torch.from_numpy(wy)).sum().backward()
    return y.detach().numpy(), block, _block_grads(block, t)


@pytest.mark.parametrize("lanes,cin,cout", DOWN)
def test_downsampler_matches_jax(lanes, cin, cout):
    rng = np.random.default_rng(5)
    x, params, stats, wy = _down_case(rng, lanes, cin, cout)
    jy, jns, jg = _jax_block(pg.downsampler_packed, params, stats, x, wy,
                             wy.shape, cin=lanes, cout=cout)
    y, block, g = _run_down(x, params, stats, wy, lanes, cin, cout)
    np.testing.assert_allclose(y, jy, atol=2e-4, rtol=1e-3)
    _assert_stats(block.bn, jns)
    jg["x"] = jg["x"][..., :cin]
    _assert_grads(g, jg)


@pytest.mark.parametrize("lanes,cin,cout", DOWN)
def test_downsampler_tie_routing_follows_the_where_chain(lanes, cin, cout):
    """Planted windows tie two non-zero maxima at (row 1, col 0) and (row
    0, col 1), and the relu'd input has all-zero windows. `downsampler_op`
    routes every window as the JAX kernel does (rows first: (1, 0) wins);
    PyTorch's pool, on the `fused_maps=False` path, sends the planted
    windows' gradient to (0, 1)."""
    rng = np.random.default_rng(6)
    x, params, stats, wy = _down_case(rng, lanes, cin, cout, ties=True)
    windows = x[..., :cin].reshape(B, 4, 2, -1, 2, cin).max(axis=(2, 4))
    assert (windows == 0).mean() > 0.02
    _, _, jg = _jax_block(pg.downsampler_packed, params, stats, x, wy,
                          wy.shape, cin=lanes, cout=cout)
    _, _, g = _run_down(x, params, stats, wy, lanes, cin, cout)
    jdx = jg["x"][..., :cin]
    np.testing.assert_allclose(g["x"], jdx, atol=2e-3 * np.abs(jdx).max(),
                               rtol=2e-3)
    _, _, g0 = _run_down(x, params, stats, wy, lanes, cin, cout,
                         fused_maps=False)
    moved = np.abs(g0["x"] - g["x"])
    assert moved[:, 1::4, 0::4].max() > 0.05 * np.abs(jdx).max()
    assert moved[:, 0::4, 1::4].max() > 0.05 * np.abs(jdx).max()
    others = moved.copy()
    others[:, 1::4, 0::4] = others[:, 0::4, 1::4] = 0.0
    assert others.max() <= 2e-3 * np.abs(jdx).max()


@pytest.mark.parametrize("cin,cout", UP)
def test_upsampler_matches_jax(cin, cout):
    rng = np.random.default_rng(3)
    H, W = 4, 256 // cin * 2
    x = _f32(rng, B, H, W, cin)
    params, stats = _block_params(rng, (3, 3, cin, cout), cout)
    wy = _f32(rng, B, 2 * H, 2 * W, cout)
    jy, jns, jg = _jax_block(pg.upsampler_packed, params, stats, x, wy,
                             wy.shape, cin=cin, cout=cout)
    block = _load(UpsamplerBlock(cin, cout),
                  upsampler_state(params, stats, "b"))
    t = torch.from_numpy(x).requires_grad_()
    y = tg.upsampler_train(t, block, train=True)
    (y * torch.from_numpy(wy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), jy, atol=2e-4, rtol=1e-3)
    _assert_stats(block.bn, jns)
    _assert_grads(_block_grads(block, t, convt=True), jg)


def _head_case(rng, H2=4, W2=16, C=4):
    cin = 16
    x = _f32(rng, B, H2, W2, cin)
    params = {"kernel": _f32(rng, 2, 2, cin, C, scale=0.2),
              "bias": _f32(rng, C, scale=0.1)}
    conv = torch.nn.ConvTranspose2d(cin, C, 2, stride=2)
    conv.load_state_dict({k[len("b."):]: v for k, v in
                          conv_transpose_state(params, "b").items()})
    return x, params, conv


def _head_grads(conv, t):
    return {"x": t.grad.numpy(), "kernel": _convt_kernel(conv.weight.grad),
            "bias": conv.bias.grad.numpy()}


@pytest.mark.parametrize("cout", [2, 4])
def test_head_matches_jax(cout):
    """The 2x2/s2 head where the tail is not fused: `lane_maps_op` with f32
    output and no moments, as `head_packed` runs it, at the BEV profile's
    2 lanes and the BP profile's 4 (JAX's head packs 32 input pixels a row
    at cout 2, 16 at cout 4)."""
    rng = np.random.default_rng(4)
    W2 = 16 if cout == 4 else 32
    x, params, conv = _head_case(rng, W2=W2, C=cout)
    wy = _f32(rng, B, 8, 2 * W2, cout)

    def f(p, xx):
        y = pg.head_packed(xx.reshape(B, 4, -1), p, cin=16, cout=cout,
                           pallas=True).reshape(wy.shape)
        return jnp.sum(y * wy), y
    (_, jy), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    y = tg.head_train(t, conv)
    assert y.dtype == torch.float32
    (y * torch.from_numpy(wy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=2e-4,
                               rtol=1e-3)
    _assert_grads(_head_grads(conv, t),
                  {"x": np.asarray(gx), "kernel": np.asarray(gp["kernel"]),
                   "bias": np.asarray(gp["bias"])})


def test_head_rowsums_matches_jax():
    """The fused tail against the JAX `head_rowsums_op`, called with the
    constants `LaneNet.apply_packed` builds (models/lanenet.py:257-273)."""
    rng = np.random.default_rng(7)
    H, W, C, zero = 32, 64, 4, 7
    x, params, conv = _head_case(rng, H // 2, W // 2)
    xs = np.linspace(-1, 1, W).astype(np.float32)
    w0, w1 = _f32(rng, B, C, H), _f32(rng, B, C, H)

    def f(p, xx):
        plan, maps, btile, in_lanes, out_lanes = pg.head_plan_maps(p, 16, C)
        assert out_lanes == 128
        plane = xx.reshape(B, H // 2, -1)
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
        return jnp.sum(S0 * w0) + jnp.sum(S1 * w1), (S0, S1)
    (_, (jS0, jS1)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))

    t = torch.from_numpy(x).requires_grad_()
    S0, S1 = tg.head_rowsums_train(t, conv, torch.from_numpy(xs), zero)
    assert S0.shape == S1.shape == (B, C, H)
    ((S0 * torch.from_numpy(w0)).sum()
     + (S1 * torch.from_numpy(w1)).sum()).backward()
    np.testing.assert_allclose(S0.detach().numpy(), np.asarray(jS0),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(S1.detach().numpy(), np.asarray(jS1),
                               atol=2e-4, rtol=1e-3)
    assert np.all(S0.detach().numpy()[:, :, :zero] == 0)
    _assert_grads(_head_grads(conv, t),
                  {"x": np.asarray(gx), "kernel": np.asarray(gp["kernel"]),
                   "bias": np.asarray(gp["bias"])})
    # and against the unfused tail of the port: head, activation, rowsums
    u0, u1 = tg.rowsums(tg.head_train(t, conv), torch.square,
                        torch.from_numpy(xs), zero)
    torch.testing.assert_close(S0, u0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(S1, u1, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# The explicit plain backward against autograd of the plain forward
# ----------------------------------------------------------------------

# name -> (x shape, weight shape, (op, plain forward), cotangent shapes)
def _op_cases():
    xs = torch.linspace(-1, 1, 32)
    down = lambda cin, cout, w: (
        (B, 8, w, cin), (cout - cin, cin, 3, 3),
        (lm.downsampler_op, lm.downsampler_fwd_plain),
        [(B, 4, w // 2, cout), (2, cout)])
    up = lambda cin, cout, w: (
        (B, 4, w, cin), (cin, cout, 3, 3),
        (lambda *a: lm.lane_maps_op(*a, 3),
         lambda *a: lm.lane_maps_fwd_plain(*a, 3)),
        [(B, 8, 2 * w, cout), (2, cout)])
    return {
        "down3-16": down(3, 16, 128), "down16-64": down(16, 64, 32),
        "down64-128": down(64, 128, 8),
        "up128-64": up(128, 64, 4), "up64-16": up(64, 16, 8),
        "head": ((B, 4, 16, 16), (16, 4, 2, 2),
                 (lambda *a: lm.lane_maps_op(*a, 2, torch.float32, False),
                  lambda *a: lm.lane_maps_fwd_plain(*a, 2, torch.float32,
                                                    False)),
                 [(B, 8, 32, 4)]),
        "head_rowsums": ((B, 4, 16, 16), (16, 4, 2, 2),
                         (lambda *a: lm.head_rowsums_op(*a, xs, 2),
                          lambda *a: lm.head_rowsums_fwd_plain(*a, xs, 2)),
                         [(B, 8, 8)])}


OPS = list(_op_cases())


def _op_run(name, which, dtype=torch.float32, seed=8):
    xshape, wshape, fns, cots = _op_cases()[name]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(np.maximum(_f32(rng, *xshape), -0.5))
    w = torch.from_numpy(_f32(rng, *wshape, scale=0.2))
    nb = wshape[0] if name.startswith("down") else wshape[1]
    b = torch.from_numpy(_f32(rng, nb, scale=0.1))
    # cotangents: of the plane, and (non-zero) of the moments
    cots = [torch.from_numpy(_f32(rng, *s, scale=1.0 if i == 0 else 0.01))
            for i, s in enumerate(cots)]
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    out = fns[which](leaves[0].to(dtype), leaves[1], leaves[2])
    out = [o for o in (out if isinstance(out, tuple) else (out,))
           if o is not None]
    loss = sum((o.float() * c).sum() for o, c in zip(out, cots))
    grads = torch.autograd.grad(loss, leaves)
    return ([o.detach().float().numpy() for o in out],
            dict(zip(("x", "weight", "bias"), (g.numpy() for g in grads))))


@pytest.mark.parametrize("name", OPS)
def test_plain_backward_matches_autograd(name):
    """The explicit plain backward (the kernels' order of operations)
    against torch.autograd of the plain forward, float32: they differ only
    by summation order, the pool routing included."""
    out, g = _op_run(name, 0)
    pout, ag = _op_run(name, 1)
    for a, b in zip(out, pout):
        np.testing.assert_array_equal(a, b)
    _assert_grads(g, ag, tol=1e-5)


@pytest.mark.parametrize("name", OPS)
def test_bf16_plain_versions_agree(name):
    """On bf16 planes the explicit backward rounds the output gradient and
    dx to bf16 where the kernels do, autograd of the plain forward does
    not: they agree to a few bf16 steps (2^-8 each) of the largest
    gradient. Outputs are bf16 (the head's stay f32), moments and row sums
    f32 within bf16's reach of the f32 run."""
    out, g = _op_run(name, 0, torch.bfloat16)
    _, ag = _op_run(name, 1, torch.bfloat16)
    fout, _ = _op_run(name, 0)
    # (dec^2)^2 quadruples the operands' relative rounding error
    tol = 8e-2 if name == "head_rowsums" else 2e-2
    for a, b in zip(out, fout):
        assert np.abs(a - b).max() <= tol * np.abs(b).max()
    _assert_grads(g, ag, tol=tol)


def test_cpu_tensors_launch_no_kernel_and_other_devices_raise():
    ops = (lm.downsampler_op, lm.lane_maps_op, lm.head_rowsums_op)
    counts = lambda: [(f.launches, f.bwd_launches) for f in ops]
    before = counts()
    for name in ("down16-64", "up64-16", "head_rowsums"):
        _op_run(name, 0)
    assert counts() == before
    meta = lambda *s: torch.zeros(*s, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        lm.downsampler_op(meta(1, 8, 8, 16), torch.zeros(48, 16, 3, 3),
                          torch.zeros(48))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        lm.lane_maps_op(meta(1, 8, 8, 64), torch.zeros(64, 16, 3, 3),
                        torch.zeros(16), 3)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        lm.head_rowsums_op(meta(1, 8, 8, 16), torch.zeros(16, 4, 2, 2),
                           torch.zeros(4), torch.zeros(16), 2)
