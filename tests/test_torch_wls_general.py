"""K12 `wls_moments` and the general-homography WLS fit of the PyTorch port
against the JAX package on the CPU.

The port's plain version (what the wrapper runs on a CPU tensor) against
JAX `pallas_wls.wls_moments` in interpret mode and a float64 oracle at
JAX's own shapes and bars (tests/test_pallas_wls.py:56-84); the port's
`WLSFitter` on a non-separable homography, the BP pixel trapezoid composed
with a 2 degree camera roll (`M_roll`), against JAX `WLSFitter(use_pallas=
True, pallas_interpret=True)`: beta at rtol 2e-3, atol 2e-4 and its
gradient at rtol 2e-3, atol 1e-4 (JAX's bars for its Pallas fitter against
its XLA one, tests/test_pallas_wls.py:99, :117). Both shipped homographies
are separable, so only such a rolled matrix reaches K12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.geometry import (
    bev_matrices_normalized as jax_norm, bev_matrices_pixel as jax_pixel)
from lanedetection_end2end_tpu.ops.pallas_wls import wls_moments as jax_moments
from lanedetection_end2end_tpu.ops.wls import WLSFitter as JaxFitter
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.geometry import (
    bev_matrices_normalized, bev_matrices_pixel, camera_roll)
from lanedetection_end2end_tpu_torch.models.lanenet import make_fitter
from lanedetection_end2end_tpu_torch.ops.wls import WLSFitter
from lanedetection_end2end_tpu_torch.ops.wls_moments import (
    wls_moments, wls_moments_bwd_plain, wls_moments_plain)

ROLL = 2.0  # degrees


def m_roll(resize):
    """BP pixel trapezoid of a (resize, 2 resize) image after a camera roll
    about the image centre."""
    return bev_matrices_pixel(resize)[0] @ camera_roll(ROLL, resize,
                                                       resize / 2)


def m_roll_normalized():
    return bev_matrices_normalized()[0] @ camera_roll(ROLL, 0.5, 0.5)


def _oracle(w, basis):
    return (w.astype(np.float64) ** 2) @ basis.astype(np.float64)


@pytest.mark.parametrize("shape", [(8, 1024, 12), (3, 4096, 30),
                                   (32, 2000, 6)])
def test_wls_moments_plain_matches_jax_and_oracle(shape):
    BC, N, K = shape
    rng = np.random.default_rng(1)
    w = rng.normal(size=(BC, N)).astype(np.float32)
    basis = rng.normal(size=(N, K)).astype(np.float32)
    got = wls_moments_plain(torch.from_numpy(w), torch.from_numpy(basis))
    assert got.dtype == torch.float32 and tuple(got.shape) == (BC, K)
    want = np.asarray(jax_moments(jnp.asarray(w), jnp.asarray(basis), 1024,
                                  True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), _oracle(w, basis), rtol=1e-4,
                               atol=1e-3)


def test_wls_moments_grad_matches_jax():
    BC, N, K = 4, 512, 6
    rng = np.random.default_rng(2)
    w = rng.normal(size=(BC, N)).astype(np.float32)
    basis = rng.normal(size=(N, K)).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jax_moments(
        a, jnp.asarray(basis), 256, True) ** 2))(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_(True)
    (wls_moments(wt, torch.from_numpy(basis)) ** 2).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), want, rtol=1e-3, atol=1e-2)
    m = _oracle(w, basis)
    oracle = 2 * w * ((2 * m) @ basis.astype(np.float64).T)
    np.testing.assert_allclose(wt.grad.numpy(), oracle, rtol=1e-3, atol=1e-2)


def test_wls_moments_layouts_agree_and_wrapper_is_plain_on_cpu():
    """(B, N, C) with the lanes innermost gives the rows b*C + c of the
    (BC, N) layout; on a CPU tensor the wrapper is the plain version, its
    gradient the plain backward, and no kernel launch is counted."""
    B, N, C, K = 3, 700, 4, 20
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.uniform(0, 1, (B, N, C)).astype(np.float32))
    basis = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32))
    flat = w.permute(0, 2, 1).reshape(B * C, N)
    got = wls_moments_plain(w, basis)
    assert torch.equal(got, wls_moments_plain(flat, basis))
    before = wls_moments.launches
    wt = w.clone().requires_grad_(True)
    m = wls_moments(wt, basis)
    assert torch.equal(m, got)
    g = torch.from_numpy(rng.normal(size=(B * C, K)).astype(np.float32))
    m.backward(g)
    assert torch.equal(wt.grad, wls_moments_bwd_plain(w, basis, g))
    assert wls_moments.launches == before


def _fitters(M, jM, H, W, order, normalized, reg_ls):
    np.testing.assert_array_equal(M, jM)
    return (WLSFitter(M, H, W, order, normalized=normalized, reg_ls=reg_ls,
                      device="cpu"),
            JaxFitter(jM, H, W, order, normalized=normalized, reg_ls=reg_ls,
                      use_pallas=True, pallas_interpret=True))


def test_separability_matches_jax():
    """The rolled matrices are general on both sides; the shipped ones are
    row-separable on both sides."""
    cases = [(m_roll(32), False, False),
             (m_roll_normalized(), True, False),
             (bev_matrices_pixel(64)[0], False, True),
             (bev_matrices_pixel(256)[0], False, True),
             (bev_matrices_normalized()[0], True, True)]
    for M, normalized, separable in cases:
        fit = WLSFitter(M, 32, 64, 2, normalized=normalized, device="cpu")
        jfit = JaxFitter(M, 32, 64, 2, normalized=normalized,
                         use_pallas=False)
        assert fit.separable == jfit.separable == separable
        assert (fit.basis is None) == separable
    # the matrices themselves equal the JAX package's own
    np.testing.assert_array_equal(bev_matrices_pixel(256)[0],
                                  jax_pixel(256)[0])
    np.testing.assert_array_equal(bev_matrices_normalized()[0],
                                  jax_norm()[0])


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_general_constants_match_jax(order):
    fit, jfit = _fitters(m_roll(32), m_roll(32), 32, 64, order, False, 1.0)
    assert fit.y_scale == jfit.y_scale
    assert tuple(fit.basis.shape) == (32 * 64, (order + 1) * (order + 2))
    np.testing.assert_array_equal(fit.basis.numpy(), np.asarray(jfit.basis))


def _wmaps(H, W, seed, lo=0.0):
    """Positive weight maps (2, H, W, 4), top rows masked, one lane of the
    second image all zero."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(lo, 1, (2, H, W, 4)).astype(np.float32)
    w[:, :H // 5] = 0.0
    w[1, :, :, 2] = 0.0
    return w


CASES = [(m_roll(32), False, order, 1.0) for order in range(4)]
CASES.append((m_roll_normalized(), True, 2, 1e-4))
IDS = [f"pixel-order{o}" for o in range(4)] + ["normalized-order2"]


@pytest.mark.parametrize("M,normalized,order,reg_ls", CASES, ids=IDS)
def test_general_fit_matches_jax(M, normalized, order, reg_ls):
    """Against JAX's Pallas fitter (interpret mode) and its XLA fitter."""
    H, W = 32, 64
    fit, jfit = _fitters(M, M, H, W, order, normalized, reg_ls)
    jplain = JaxFitter(M, H, W, order, normalized=normalized, reg_ls=reg_ls,
                       use_pallas=False)
    w = _wmaps(H, W, 10 + order)
    want = np.asarray(jfit(jnp.asarray(w), layout="nhwc"))
    got = fit(torch.from_numpy(w)).numpy()
    assert got.shape == (2, 4, order + 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(
        got, np.asarray(jplain(jnp.asarray(w), layout="nhwc")), rtol=2e-3,
        atol=2e-4)


@pytest.mark.parametrize("M,normalized,order,reg_ls",
                         [(m_roll(16), False, 3, 1.0),
                          (m_roll_normalized(), True, 1, 1e-3)],
                         ids=["pixel-order3", "normalized-order1"])
def test_general_fit_grad_matches_jax(M, normalized, order, reg_ls):
    H, W = 16, 32
    fit, jfit = _fitters(M, M, H, W, order, normalized, reg_ls)
    w = _wmaps(H, W, 20 + order, lo=0.1)
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        jfit(a, layout="nhwc") ** 2))(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_(True)
    (fit(wt) ** 2).sum().backward()
    assert wt.grad is not None and torch.isfinite(wt.grad).all()
    np.testing.assert_allclose(wt.grad.numpy(), want, rtol=2e-3, atol=1e-4)


def test_general_fit_zero_maps_stay_finite():
    fit, jfit = _fitters(m_roll(32), m_roll(32), 32, 64, 3, False, 0.0)
    w = np.zeros((2, 32, 64, 4), np.float32)
    got = fit(torch.from_numpy(w))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jfit(jnp.asarray(w), layout="nhwc")),
        rtol=2e-3, atol=2e-4)


def test_general_fit_refuses_row_sums_and_config_reaches_fitter():
    """`beta_from_rowsums` keeps JAX's separability assertion; the
    config's fit (order, reg_ls, its BP homography, separable) reaches the
    fitter `make_fitter` builds, equal to JAX's on its constants."""
    fit = WLSFitter(m_roll(32), 32, 64, 3, normalized=False,
                    device="cpu")
    S = torch.zeros(1, 4, 32)
    with pytest.raises(AssertionError, match="row-aligned"):
        fit.beta_from_rowsums(S, S)
    cfg = train_sh_config(resize=32, order=2, reg_ls=0.5)
    made = make_fitter(cfg, "cpu")
    jfit = JaxFitter(jax_pixel(32)[0], 32, 64, 2, normalized=False,
                     reg_ls=0.5, use_pallas=False)
    assert (made.order, made.reg_ls, made.separable) == (2, 0.5, True)
    assert made.basis is None and made.y_scale == jfit.y_scale
