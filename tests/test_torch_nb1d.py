"""K1 nb1d of the PyTorch port: its plain version (what the wrapper runs on
a CPU tensor) against the JAX Pallas block `nb1d_fused` in interpret mode,
on the same bf16 input and the same weights carried across by the port's
converters. The JAX kernel's Winograd and banded tap forms round
differently in bf16 than direct taps, hence max|diff| / max|ref| < 1e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.models.erfnet import NonBottleneck1D
from lanedetection_end2end_tpu.ops.pallas_nb1d import nb1d_fused
from lanedetection_end2end_tpu.ops.pallas_nb1d import pack_nb1d as jax_pack
from lanedetection_end2end_tpu_torch.models.port import nb1d_state
from lanedetection_end2end_tpu_torch.ops.nb1d import (
    fold_bn, nb1d, nb1d_plain, pack_nb1d)
from test_torch_threads import one_torch_thread  # noqa: F401


def _block(C, d, H, W, seed):
    """Random NB1D variables with non-trivial BatchNorm, and a bf16 input."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, H, W, C)).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    v = jax.device_get(NonBottleneck1D(C, 0.0, d).init(
        {"params": jax.random.PRNGKey(seed)}, jnp.asarray(x), train=False))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    for bn in ("bn1", "bn2"):
        params[bn] = {"scale": rng.uniform(0.8, 1.2, C).astype(np.float32),
                      "bias": rng.normal(0, 0.1, C).astype(np.float32)}
        stats[bn] = {"mean": rng.normal(0, 0.1, C).astype(np.float32),
                     "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    return x, params, stats


# C in {16, 64, 128}, d in {1, 2, 8, 16}; the last two have d >= H, and the
# last also d*C >= W*C: taps that fall entirely off the plane
CASES = [(16, 1, 16, 32), (16, 2, 16, 32), (64, 1, 8, 16), (64, 8, 16, 32),
         (128, 2, 8, 16), (128, 8, 8, 16), (128, 16, 8, 16)]


@pytest.mark.parametrize("C,d,H,W", CASES)
def test_nb1d_plain_matches_jax_kernel(C, d, H, W):
    x, params, stats = _block(C, d, H, W, seed=C + d)
    want = np.asarray(nb1d_fused(jnp.asarray(x, jnp.bfloat16),
                                 jax_pack(params, stats, d), dilation=d,
                                 interpret=True).astype(jnp.float32))
    p = pack_nb1d(nb1d_state(params, stats, "blk"), "blk", d)
    got = nb1d_plain(torch.from_numpy(x).to(torch.bfloat16), p)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err < 1e-2, (C, d, err)


def test_nb1d_wrapper_on_cpu_is_plain_and_counts_nothing():
    x, params, stats = _block(64, 2, 8, 16, seed=3)
    p = pack_nb1d(nb1d_state(params, stats, "blk"), "blk", 2)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    before = nb1d.launches
    assert torch.equal(nb1d(xt, p), nb1d_plain(xt, p))
    assert nb1d.launches == before


def test_fold_bn_matches_jax():
    from lanedetection_end2end_tpu.ops.pallas_nb1d import fold_bn as jax_fold
    _, params, stats = _block(16, 1, 8, 8, seed=5)
    sd = nb1d_state(params, stats, "blk")
    mul, add = fold_bn(sd, "blk.bn1")
    jmul, jadd = jax_fold(params["bn1"], stats["bn1"], 1e-3)
    np.testing.assert_allclose(mul.numpy(), jmul, rtol=1e-6)
    np.testing.assert_allclose(add.numpy(), jadd, rtol=1e-6, atol=1e-7)
