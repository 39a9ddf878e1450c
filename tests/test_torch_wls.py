"""The port's unrolled SPD solve and separable WLS fit against the JAX
package, in float32 (rtol 1e-5 where both sides do the same f32 math)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.geometry import bev_matrices_pixel as jax_bev
from lanedetection_end2end_tpu.ops.solve import spd_solve as jax_solve
from lanedetection_end2end_tpu.ops.wls import WLSFitter as JaxFitter
from lanedetection_end2end_tpu_torch.geometry import bev_matrices_pixel
from lanedetection_end2end_tpu_torch.ops.solve import spd_solve
from lanedetection_end2end_tpu_torch.ops.wls import WLSFitter
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_spd_solve_matches_jax(n):
    rng = np.random.default_rng(n)
    A = rng.normal(size=(6, n, n))
    Z = (A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(n)).astype(np.float32)
    x = rng.normal(size=(6, n)).astype(np.float32)
    got = spd_solve(torch.from_numpy(Z), torch.from_numpy(x)).numpy()
    want = np.asarray(jax_solve(jnp.asarray(Z), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _fitters(resize, order, reg_ls):
    M, _ = bev_matrices_pixel(resize)
    jM, _ = jax_bev(resize)
    np.testing.assert_array_equal(M, jM)
    H, W = resize, 2 * resize
    return (WLSFitter(M, H, W, order, normalized=False, reg_ls=reg_ls,
                      device="cpu"),
            JaxFitter(jM, H, W, order, normalized=False, reg_ls=reg_ls,
                      use_pallas=False))


@pytest.mark.parametrize("resize,order,reg_ls", [(64, 3, 1.0), (64, 2, 0.0),
                                                 (256, 3, 0.0)])
def test_constants_match_jax(resize, order, reg_ls):
    fit, jfit = _fitters(resize, order, reg_ls)
    assert fit.separable and jfit.separable
    assert fit.y_scale == jfit.y_scale
    np.testing.assert_array_equal(fit.sep_coeff.numpy(),
                                  np.asarray(jfit._sep_coeff))
    np.testing.assert_array_equal(fit.sep_xs.numpy(),
                                  np.asarray(jfit._sep_xs))


def _wmaps(resize, seed):
    """Positive weight maps, top rows masked, one lane all zero."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 1, (2, resize, 2 * resize, 4)).astype(np.float32)
    w[:, :resize // 5] = 0.0
    w[1, :, :, 2] = 0.0
    return w


@pytest.mark.parametrize("resize,order,reg_ls", [(64, 3, 1.0), (64, 2, 0.0),
                                                 (256, 3, 0.0)])
def test_beta_from_rowsums_matches_jax(resize, order, reg_ls):
    fit, jfit = _fitters(resize, order, reg_ls)
    w2 = _wmaps(resize, resize + order) ** 2
    xs = np.asarray(jfit._sep_xs)
    S0 = w2.sum(axis=2).transpose(0, 2, 1)
    S1 = (w2 * xs[None, None, :, None]).sum(axis=2).transpose(0, 2, 1)
    got = fit.beta_from_rowsums(torch.from_numpy(S0),
                                torch.from_numpy(S1)).numpy()
    want = np.asarray(jfit.beta_from_rowsums(jnp.asarray(S0),
                                             jnp.asarray(S1)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_fit_from_weight_maps_matches_jax():
    fit, jfit = _fitters(64, 3, 1.0)
    w = _wmaps(64, 7)
    got = fit(torch.from_numpy(w)).numpy()
    want = np.asarray(jfit(jnp.asarray(w), layout="nhwc"))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_all_zero_rowsums_stay_finite():
    fit, jfit = _fitters(64, 3, 0.0)
    S = np.zeros((2, 4, 64), np.float32)
    got = fit.beta_from_rowsums(torch.from_numpy(S), torch.from_numpy(S))
    want = np.asarray(jfit.beta_from_rowsums(jnp.asarray(S), jnp.asarray(S)))
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got.numpy(), want)


def test_non_separable_homography_is_refused():
    """A general homography takes the full-grid path
    (tests/test_torch_wls_general.py); the row-sum fit refuses it, as JAX's
    `beta_from_rowsums` does."""
    M = np.eye(3)
    M[2, 0] = 1e-3
    fit = WLSFitter(M, 8, 16, 2, normalized=False, device="cpu")
    assert not fit.separable and fit.sep_coeff is None
    S = torch.zeros(1, 4, 8)
    with pytest.raises(AssertionError):
        fit.beta_from_rowsums(S, S)
