"""`channel_sums` of the port (`ops/packed_conv.py`) against the JAX
package's Pallas kernel (`ops/pallas_packed_conv.py`, interpret mode) on
the CPU: the per-channel sums and sums of squares, and their backward
dx = ds1 + 2 x ds2. f32 sums in another order: rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.ops import packed_graph as pg
from lanedetection_end2end_tpu.ops.pallas_packed_conv import (
    channel_sums as jax_channel_sums)
from lanedetection_end2end_tpu_torch.ops.packed_conv import (
    channel_sums, channel_sums_plain)
from test_torch_threads import one_torch_thread  # noqa: F401

B, H = 2, 8


def _jax_sums(x, C):
    """x (B, H, W, C) -> ((2, C) sums, dx) with cotangent `wm`."""
    sel = jnp.zeros((128, 128), jnp.float32).at[:, :C].set(
        jnp.asarray(pg._chan_select(C)))
    return lambda xx: jax_channel_sums(
        xx.reshape(B, H, -1), sel, C, True)[:, :C]


@pytest.mark.parametrize("C,W", [(16, 32), (64, 8), (128, 4)])
def test_channel_sums_matches_jax(C, W):
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 1, (B, H, W, C)).astype(np.float32)
    wm = rng.normal(0, 1, (2, C)).astype(np.float32)
    f = _jax_sums(x, C)
    jsums, vjp = jax.vjp(f, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(wm))
    t = torch.from_numpy(x).requires_grad_()
    sums = channel_sums(t)
    (sums * torch.from_numpy(wm)).sum().backward()
    assert sums.shape == (2, C) and sums.dtype == torch.float32
    np.testing.assert_allclose(sums.detach().numpy(), np.asarray(jsums),
                               rtol=1e-5, atol=1e-4)
    # a float64 witness bounds the f32 sums at the same bar
    xd = x.astype(np.float64).reshape(-1, C)
    np.testing.assert_allclose(sums.detach().numpy(),
                               np.stack([xd.sum(0), (xd * xd).sum(0)]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)


def test_channel_sums_bf16_plane_and_plain():
    """A bf16 plane gives f32 sums of its exact values and a bf16
    gradient; the wrapper on a CPU tensor is the plain version."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, H, 8, 16, generator=g).to(torch.bfloat16)
    x.requires_grad_()
    sums = channel_sums(x)
    want = channel_sums_plain(x.detach())
    assert torch.equal(sums, want)
    xf = x.detach().double().reshape(-1, 16)
    np.testing.assert_allclose(want[0].numpy(), xf.sum(0).numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(want[1].numpy(), (xf * xf).sum(0).numpy(),
                               rtol=1e-5)
    sums.sum().backward()
    assert x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(x.grad.float().numpy(),
                               (1 + 2 * x.detach().float()).to(
                                   torch.bfloat16).float().numpy())


def test_channel_sums_launches_no_kernel_on_cpu_and_refuses_meta():
    before = channel_sums.launches
    channel_sums(torch.zeros(1, 2, 2, 16))
    assert channel_sums.launches == before
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        channel_sums(torch.zeros(1, 2, 2, 16, dtype=torch.bfloat16,
                                 device="meta"))
