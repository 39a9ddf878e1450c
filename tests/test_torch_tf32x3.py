"""The 3xTF32 split of the float32 training convolutions
(`lanedetection_end2end_tpu_torch/ops/tf32x3.py`), checked on the CPU.

The float32 tiles of `csrc/conv3tap_f32.cuh` split every f32 operand into
two TF32 values and take three TF32 products. These tests hold that
arithmetic where no card is needed: `round_tf32` rounds as
`cvt.rna.tf32.f32` does; the three-product convolution reads within
TOL_F32 / 10 of a float64 convolution, while one TF32 product alone reads
above TOL_F32 (the control: it shows the bar can tell the two apart at
these shapes), and the same holds for the weight gradient, the float32
tiles' other product; and the JAX package's float32 `nb_half_a` / `nb_half_b`
forward (Pallas in interpret mode) agrees with the port's half blocks built
on the three-product convolution at TOL_F32, the bar `chip_smoke.py` holds
the float32 kernels to on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.ops import packed_graph as pg
from lanedetection_end2end_tpu.ops import pallas_nb_block as jnb
from lanedetection_end2end_tpu_torch.ops import nb_block as nb
from lanedetection_end2end_tpu_torch.ops.tf32x3 import (
    _conv3_f64, conv3_tf32, conv3_tf32x3, round_tf32, split_tf32,
    wgrad3_tf32, wgrad3_tf32x3)

TOL_F32 = 1e-4  # chip_smoke.py's bar for float32 planes, of max|reference|
B, H, W = 2, 8, 16


def _f32(*values):
    return torch.tensor(values, dtype=torch.float32)


def _bits(t):
    return t.view(torch.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_round_tf32_keeps_tf32_values_and_is_idempotent():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 1e3)
    r = round_tf32(x)
    assert (_bits(r) & 0x1FFF == 0).all()  # 10 mantissa bits left
    assert torch.equal(round_tf32(r), r)
    # nearest: within half a TF32 step (2^-11 of the binade's base)
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    exact = _f32(0.0, -0.0, 1.0, -1.5, 1.0 + 2.0 ** -10, 3.0 * 2.0 ** -20,
                 float("inf"), float("-inf"))
    assert torch.equal(_bits(round_tf32(exact)), _bits(exact))


def test_round_tf32_rounds_ties_away_from_zero():
    ulp = 2.0 ** -10  # TF32's step in [1, 2)
    tie = 1.0 + ulp / 2  # exactly halfway between 1 and 1 + ulp
    assert round_tf32(_f32(tie)).item() == 1.0 + ulp
    assert round_tf32(_f32(-tie)).item() == -(1.0 + ulp)
    # off the tie, to the nearest
    assert round_tf32(_f32(1.0 + ulp / 2 - 2.0 ** -23)).item() == 1.0
    assert round_tf32(_f32(1.0 + 3 * ulp / 2)).item() == 1.0 + 2 * ulp
    # the carry into the exponent
    assert round_tf32(_f32(2.0 - 2.0 ** -23)).item() == 2.0


def test_split_tf32_keeps_float32_accuracy():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi, lo = split_tf32(x)
    assert (_bits(hi) & 0x1FFF == 0).all() and (_bits(lo) & 0x1FFF == 0).all()
    assert torch.equal(hi, round_tf32(x))
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= x.double().abs() * 2.0 ** -21).all()


def _plane(C, seed):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, C, C))
                          / np.sqrt(3 * C)).astype(np.float32))
    return t, w


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("d", [1, 2, 16])
@pytest.mark.parametrize("C", [16, 64, 128])
def test_three_products_keep_float32_one_does_not(C, d, axis):
    t, w = _plane(C, seed=C + d + axis)
    ref = _conv3_f64(t, w, axis, d)
    x3 = _rel(conv3_tf32x3(t, w, axis, d), ref)
    x1 = _rel(conv3_tf32(t, w, axis, d), ref)
    assert x3 < TOL_F32 / 10, x3
    assert x1 > TOL_F32, x1  # the control


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("d", [1, 2, 16])
@pytest.mark.parametrize("C", [16, 64, 128])
def test_weight_gradient_three_products_keep_float32_one_does_not(C, d,
                                                                 axis):
    t, _ = _plane(C, seed=C + d + axis)
    dy, _ = _plane(C, seed=2 * C + d + axis + 1)
    ref = nb._wgrad3(t.double(), dy.double(), axis, d)
    x3 = _rel(wgrad3_tf32x3(t, dy, axis, d), ref)
    x1 = _rel(wgrad3_tf32(t, dy, axis, d), ref)
    assert x3 < TOL_F32 / 10, x3
    assert x1 > TOL_F32, x1  # the control


def _kexp(k, C):
    return jnp.stack([pg._expand(jnp.asarray(k[t]), C) for t in range(3)])


def _tile(b, C):
    return pg._tile_lane(jnp.asarray(b), 128, C)[None]


# (half, C, d); the last is the resize-64 NB1D-128 plane with d >= H, W
HALVES = [("a", 16, 1), ("a", 64, 1), ("a", 128, 1), ("b", 16, 1),
          ("b", 64, 2), ("b", 128, 16)]


@pytest.mark.parametrize("half,C,d", HALVES,
                         ids=[f"{h}-C{c}-d{d}" for h, c, d in HALVES])
def test_half_on_three_products_matches_jax(half, C, d):
    rng = np.random.default_rng(7)
    f = lambda *s, scale=1.0: rng.normal(0, scale, s).astype(np.float32)
    x, kh, kw = f(B, H, W, C), f(3, C, C, scale=0.2), f(3, C, C, scale=0.2)
    bh, bw = f(C, scale=0.1), f(C, scale=0.1)
    mul = rng.uniform(0.5, 1.5, C).astype(np.float32)
    add = f(C, scale=0.1)

    plane = jnp.asarray(x).reshape(B, H, W * C)
    if half == "a":
        jy, jmom = jnb.nb_half_a(plane, _kexp(kh, C), _tile(bh, C),
                                 _kexp(kw, C), _tile(bw, C), C, True)
    else:
        jy, jmom = jnb.nb_half_b(plane, _tile(mul, C), _tile(add, C),
                                 _kexp(kh, C), _tile(bh, C), _kexp(kw, C),
                                 _tile(bw, C), d, d * C, True)
    jy = np.asarray(jy).reshape(B, H, W, C)
    jmom = np.asarray(jmom)[:, :C]

    T = torch.from_numpy
    y, _, mom = nb.half_fwd_plain(
        T(x), None if half == "a" else T(mul), None if half == "a" else
        T(add), T(kh), T(bh), T(kw), T(bw), d, conv=conv3_tf32x3)
    assert y.dtype == torch.float32 and mom.shape == (2, C)
    assert _rel(y, jy) <= TOL_F32
    assert _rel(mom, jmom) <= TOL_F32
