"""The port's losses and metric (`ops/losses.py`, `ops/metrics.py`) against
the JAX package's on the same numpy inputs, rtol 1e-5 (f32 arithmetic in
another order; the backprojection loss at resize 256 reaches y_eval^3 ~
1.4e9, which is why both sides keep it in full float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.ops import losses as jl
from lanedetection_end2end_tpu.ops.metrics import (
    trapezoidal_area as jax_trapezoidal_area)
from lanedetection_end2end_tpu_torch.ops import losses as tl
from lanedetection_end2end_tpu_torch.ops.metrics import trapezoidal_area
from test_torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy
RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("order,weight_funct", [
    (2, "none"), (2, "linear"), (2, "quadratic"), (1, "none")])
def test_area_loss(order, weight_funct):
    rng = np.random.default_rng(0)
    p = rng.normal(0, 1, (6, order + 1)).astype(np.float32)
    g = rng.normal(0, 1, (6, order + 1)).astype(np.float32)
    g[1] = 0.0       # an absent lane
    g[4, 0] = 0.0    # one zero coefficient also marks a lane absent
    _close(tl.area_loss(T(p), T(g), order, weight_funct),
           jl.area_loss(jnp.asarray(p), jnp.asarray(g), order, weight_funct))
    z = np.zeros_like(g)
    assert float(tl.area_loss(T(p), T(z), order, weight_funct)) == 0.0


def test_mse_params_loss():
    rng = np.random.default_rng(1)
    p = rng.normal(0, 1, (5, 3, 1)).astype(np.float32)
    g = rng.normal(0, 1, (5, 3)).astype(np.float32)
    _close(tl.mse_params_loss(T(p), T(g)),
           jl.mse_params_loss(jnp.asarray(p), jnp.asarray(g)))


@pytest.mark.parametrize("resize,order,no_mapping", [
    (256, 3, False), (256, 2, False), (64, 3, False), (256, 1, True)])
def test_backprojection_loss(resize, order, no_mapping):
    rng = np.random.default_rng(2)
    jc = jl.BackprojectionLoss(resize, order, no_mapping)
    tc = tl.BackprojectionLoss(resize, order, no_mapping, device="cpu")
    np.testing.assert_array_equal(tc.Y.numpy(), np.asarray(jc.Y))
    # coefficients of a plausible lane in pixel BEV coordinates
    scale = np.array([resize ** -p for p in range(order, -1, -1)]) * resize
    p = (rng.normal(0, 1, (4, order + 1)) * scale).astype(np.float32)
    x_gt = rng.uniform(0, 2 * resize, (4, 56)).astype(np.float32)
    valid = (rng.uniform(size=(4, 56)) > 0.3).astype(np.float32)
    valid[3] = 0.0
    loss, x_cal = tc(T(p), T(x_gt), T(valid))
    jloss, jx = jc(jnp.asarray(p), jnp.asarray(x_gt), jnp.asarray(valid))
    _close(loss, jloss)
    _close(x_cal, jx, atol=1e-5 * float(np.abs(np.asarray(jx)).max()))
    none_valid, _ = tc(T(p), T(x_gt), T(np.zeros_like(valid)))
    assert float(none_valid) == 0.0


def test_backprojection_loss_gradient():
    rng = np.random.default_rng(3)
    import jax
    jc = jl.BackprojectionLoss(64, 3)
    tc = tl.BackprojectionLoss(64, 3, device="cpu")
    p = rng.normal(0, 1e-3, (4, 4)).astype(np.float32)
    p[:, -1] = 60.0
    x_gt = rng.uniform(0, 128, (4, 56)).astype(np.float32)
    valid = np.ones((4, 56), np.float32)
    t = T(p).requires_grad_()
    tc(t, T(x_gt), T(valid))[0].backward()
    jg = jax.grad(lambda q: jc(q, jnp.asarray(x_gt), jnp.asarray(valid))[0])(
        jnp.asarray(p))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jg).max()))


def test_weighted_cross_entropy():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, (2, 6, 8, 5)).astype(np.float32)
    targets = rng.integers(0, 5, (2, 6, 8))
    w = np.array([1.0, 30.0, 30.0, 30.0, 30.0], np.float32)
    _close(tl.weighted_cross_entropy(T(logits), T(targets), T(w)),
           jl.weighted_cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(targets), jnp.asarray(w)))


def test_bce_with_logits():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 4, (3, 64)).astype(np.float32)
    targets = (rng.uniform(size=(3, 64)) > 0.5).astype(np.float32)
    got = tl.bce_with_logits(T(logits), T(targets))
    _close(got, jl.bce_with_logits(jnp.asarray(logits), jnp.asarray(targets)))
    _close(got, torch.nn.functional.binary_cross_entropy_with_logits(
        T(logits), T(targets)))


def test_cross_entropy_logits():
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 2, (5, 3, 4)).astype(np.float32)
    targets = rng.integers(0, 3, (5, 4))
    _close(tl.cross_entropy_logits(T(logits), T(targets)),
           jl.cross_entropy_logits(jnp.asarray(logits), jnp.asarray(targets)))


def test_trapezoidal_area():
    rng = np.random.default_rng(7)
    p = rng.normal(0, 1, (2, 5, 3)).astype(np.float32)
    g = rng.normal(0, 1, (2, 5, 3)).astype(np.float32)
    got = trapezoidal_area(T(p), T(g))
    assert got.shape == (2, 5)
    _close(got, jax_trapezoidal_area(jnp.asarray(p), jnp.asarray(g)))
