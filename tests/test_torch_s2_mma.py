"""The arithmetic of the stride-2 tensor-core tiles of K8 / K9
(`csrc/conv_s2_mma.cuh`), checked on the CPU through its plain statement
in `lanedetection_end2end_tpu_torch/ops/tf32x3.py`.

The tiles compute the transposed convolution by its four output parity
phases, interleaved: `convt_s2_phases` is held against
`F.conv_transpose2d` in float64 for k = 3 (padding 1, output padding 1)
and k = 2. In float32 the tiles take three TF32 products per f32 product:
`conv_s2_tf32x3`, `convt_s2_tf32x3` and `wgrad_s2_tf32x3` read within
TOL_F32 / 10 of float64, and their single-TF32 twins (the control
`chip_smoke.py` reads beside the kernels) above TOL_F32. Then the
downsampler and upsampler blocks, with their plain versions on those
three-product products (the `conv=` / `convt=` / `wgrad=` hooks of
`ops/lanemaps.py`), are held against the JAX package's Pallas
`downsampler_op` / `lane_maps_op` in interpret mode at the bars of
tests/test_torch_lanemaps.py. Last, the CUDA wrappers (launches stubbed,
as in tests/test_torch_f32_fused.py) refuse the shapes the kernels do not
take before any launch."""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lanedetection_end2end_tpu.ops import packed_graph as pg
from lanedetection_end2end_tpu_torch.models.erfnet import UpsamplerBlock
from lanedetection_end2end_tpu_torch.models.port import upsampler_state
from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
from lanedetection_end2end_tpu_torch.ops import packed_graph as tg
from lanedetection_end2end_tpu_torch.ops.tf32x3 import (
    conv_s2_tf32, conv_s2_tf32x3, convt_s2_phases, convt_s2_tf32,
    convt_s2_tf32x3, wgrad_s2_tf32, wgrad_s2_tf32x3)
from test_torch_f32_fused import _rn, stubs  # noqa: F401 (a fixture)
from test_torch_lanemaps import (
    _assert_grads, _assert_stats, _block_grads, _block_params, _down_case,
    _f32, _jax_block, _load, _run_down)

TOL_F32 = 1e-4  # chip_smoke.py's bar for float32 results, of max|reference|
B, HS, WS = 2, 8, 16  # the small plane; the large one is 16 x 32


def _rel(got, want):
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max()).item()


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy(_f32(rng, *shape, scale=scale))


# (cs, cl, k): small-plane and large-plane channels of the parameter
PHASES = [(48, 16, 3), (64, 16, 3), (128, 64, 3), (16, 4, 2)]


@pytest.mark.parametrize("cs,cl,k", PHASES,
                         ids=[f"{a}-{b}-k{k}" for a, b, k in PHASES])
def test_parity_phases_are_the_transposed_convolution(cs, cl, k):
    rng = np.random.default_rng(cs + cl + k)
    small = _t(rng, B, HS, WS, cs).double()
    w = _t(rng, cs, cl, k, k).double()
    ref = lm.convt_s2(small, w, k).double()
    assert ref.shape == (B, 2 * HS, 2 * WS, cl)
    pad = {"padding": 1, "output_padding": 1} if k == 3 else {}
    direct = F.conv_transpose2d(small.permute(0, 3, 1, 2), w, stride=2,
                                **pad).permute(0, 2, 3, 1)
    assert torch.equal(ref, direct)
    assert _rel(convt_s2_phases(small, w, k), ref) <= 1e-6


# name -> (three products, one product, the float64 reference, operand
# shapes): K8's forward and K9's input gradient (conv_s2), K8's input
# gradient and K9's forward (convt_s2), the weight gradients (wgrad_s2)
LARGE = (B, 2 * HS, 2 * WS)
PRODUCTS = {
    "conv_s2-16-48": (conv_s2_tf32x3, conv_s2_tf32, lm.conv_s2,
                      [LARGE + (16,), (48, 16, 3, 3)]),
    "conv_s2-16-64": (conv_s2_tf32x3, conv_s2_tf32, lm.conv_s2,
                      [LARGE + (16,), (64, 16, 3, 3)]),
    "convt_s2-48-16": (convt_s2_tf32x3, convt_s2_tf32, lm.convt_s2,
                       [(B, HS, WS, 48), (48, 16, 3, 3)]),
    "convt_s2-64-16": (convt_s2_tf32x3, convt_s2_tf32, lm.convt_s2,
                       [(B, HS, WS, 64), (64, 16, 3, 3)]),
    "wgrad_s2-48-16": (wgrad_s2_tf32x3, wgrad_s2_tf32, lm.wgrad_s2,
                       [(B, HS, WS, 48), LARGE + (16,)]),
    "wgrad_s2-128-64": (wgrad_s2_tf32x3, wgrad_s2_tf32, lm.wgrad_s2,
                        [(B, HS, WS, 128), LARGE + (64,)]),
}


@pytest.mark.parametrize("name", PRODUCTS)
def test_three_products_keep_float32_one_does_not(name):
    three, one, reference, shapes = PRODUCTS[name]
    rng = np.random.default_rng(list(PRODUCTS).index(name) + 11)
    a, b = (_t(rng, *shape) for shape in shapes)
    ref = reference(a.double(), b.double(), 3)
    got = three(a, b, 3)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    x3, x1 = _rel(got, ref), _rel(one(a, b, 3), ref)
    assert x3 <= TOL_F32 / 10, x3
    assert x1 > TOL_F32, x1  # the control


@pytest.fixture
def three_products(monkeypatch):
    """The stride-2 ops' plain versions (which the autograd.Function runs
    on CPU tensors) on the 3xTF32 products of the float32 tiles."""
    for name, hooks in (
            ("downsampler_fwd_plain", {"conv": conv_s2_tf32x3}),
            ("downsampler_bwd_plain", {"convt": convt_s2_tf32x3,
                                       "wgrad": wgrad_s2_tf32x3}),
            ("lane_maps_fwd_plain", {"convt": convt_s2_tf32x3}),
            ("lane_maps_bwd_plain", {"conv": conv_s2_tf32x3,
                                     "wgrad": wgrad_s2_tf32x3})):
        monkeypatch.setattr(lm, name,
                            functools.partial(getattr(lm, name), **hooks))
    monkeypatch.setenv("PACKED_FUSED_MAPS", "1")


# (lanes, channels, cout) of the JAX packed block, as test_torch_lanemaps
DOWN = [(16, 16, 64), (64, 64, 128)]


@pytest.mark.parametrize("lanes,cin,cout", DOWN)
def test_downsampler_on_three_products_matches_jax(three_products, lanes,
                                                   cin, cout):
    rng = np.random.default_rng(15)
    x, params, stats, wy = _down_case(rng, lanes, cin, cout, ties=True)
    jy, jns, jg = _jax_block(pg.downsampler_packed, params, stats, x, wy,
                             wy.shape, cin=lanes, cout=cout)
    y, block, g = _run_down(x, params, stats, wy, lanes, cin, cout)
    np.testing.assert_allclose(y, jy, atol=2e-4, rtol=1e-3)
    _assert_stats(block.bn, jns)
    jg["x"] = jg["x"][..., :cin]
    _assert_grads(g, jg)


UP = [(128, 64), (64, 16)]


@pytest.mark.parametrize("cin,cout", UP)
def test_upsampler_on_three_products_matches_jax(three_products, cin, cout):
    rng = np.random.default_rng(13)
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


def test_hooks_reach_the_plain_versions(three_products):
    """The fixture's hooks are what the autograd.Function runs: the
    downsampler's forward through the op equals the plain forward on
    the three-product convolution, which differs from the full-f32 one."""
    rng = np.random.default_rng(17)
    x = _t(rng, B, 2 * HS, 2 * WS, 16)
    w, b = _t(rng, 48, 16, 3, 3, scale=0.2), _t(rng, 48, scale=0.1)
    y, _ = lm.downsampler_op(x, w, b)
    want = lm.downsampler_fwd_plain.func(x, w, b, conv=conv_s2_tf32x3)[0]
    assert torch.equal(y, want)
    assert not torch.equal(y, lm.downsampler_fwd_plain.func(x, w, b)[0])


# calls of the CUDA wrappers at shapes the kernels do not take
def _down_32(rng):
    lm._downsampler_fwd_cuda(_rn(rng, 2, 4, 6, 32), _rn(rng, 32, 32, 3, 3),
                             _rn(rng, 32))


def _down_bwd_32(rng):
    lm.downsampler_bwd_kernel(_rn(rng, 2, 4, 6, 32), _rn(rng, 2, 2, 3, 64),
                              _rn(rng, 2, 2, 3, 64), _rn(rng, 2, 64),
                              _rn(rng, 32, 32, 3, 3))


def _up_32(rng):
    lm._lane_maps_fwd_cuda(_rn(rng, 2, 3, 5, 32), _rn(rng, 32, 16, 3, 3),
                           _rn(rng, 16), 3, torch.float32, True)


def _head_64(rng):
    lm.lane_maps_bwd_kernel(_rn(rng, 2, 3, 5, 64), None,
                            _rn(rng, 2, 6, 10, 4), None,
                            _rn(rng, 64, 4, 2, 2), 2)


@pytest.mark.parametrize("call", [_down_32, _down_bwd_32, _up_32, _head_64])
def test_other_shapes_raise_before_any_launch(stubs, call):  # noqa: F811
    with pytest.raises(ValueError, match="not a shape the kernels take"):
        call(np.random.default_rng(2))
    assert stubs.calls == []
