"""K11 of the port (`ops/packed_conv.py`: `packed_conv_act`, `packed_conv`,
and `channel_sums` on float32 planes) against the JAX package's Pallas
kernels (`ops/pallas_packed_conv.py`, interpret mode) on the CPU, and the
`fused_blocks` / `fused_maps` argument rule of the training path.

The JAX side works on lane-packed planes (B, H, W*C), which are the memory
of the port's NHWC planes (B, H, W, C); its taps are the block-diagonal
expansion of the (3, C, C) channel mixers the port takes, and its 'w' axis
shifts by d*C lanes where the port shifts by d columns. B, H, W = 2, 16, 32,
the cases of tests/test_packed_conv.py plus dilations that reach past the
plane (d >= H, d >= W).

Bars. float32: the JAX package's own for these kernels
(tests/test_packed_conv.py): forward rtol 1e-5, gradients rtol 1e-4 and
atol 1e-3. bfloat16: both sides round the same f32 sums once to bf16, in
another summation order, so an output may differ by one bf16 step:
1e-2 of max|JAX|. The backward is held on the JAX forward's output y, so
both sides take the relu mask from the same rounded values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.ops import packed_graph as pg
from lanedetection_end2end_tpu.ops.pallas_packed_conv import (
    channel_sums as jax_channel_sums, packed_conv as jax_packed_conv)
from lanedetection_end2end_tpu_torch.ops import packed_conv as pc
from test_torch_threads import one_torch_thread  # noqa: F401

B, H, W = 2, 16, 32
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(C, seed, dtype_name):
    """x (B, H, W, C) exact in the dtype, taps (3, C, C), bias, cotangent."""
    rng = np.random.default_rng(seed)
    tdt = DTYPES[dtype_name][1]
    x = torch.from_numpy(rng.normal(0, 1, (B, H, W, C)).astype(np.float32))
    x = x.to(tdt).float().numpy()
    k = (0.2 * rng.normal(0, 1, (3, C, C))).astype(np.float32)
    b = rng.normal(0, 1, (C,)).astype(np.float32)
    g = torch.from_numpy(rng.normal(0, 1, (B, H, W, C)).astype(np.float32))
    return x, k, b, g.to(tdt).float().numpy()


def _jax(a, dtype_name):
    return jnp.asarray(a).astype(DTYPES[dtype_name][0])


def _torch(a, dtype_name):
    return torch.from_numpy(np.array(a, np.float32)).to(
        DTYPES[dtype_name][1])


def _close(got, want, dtype_name, what, rtol=1e-4, atol=1e-3):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32).reshape(got.shape)
    if dtype_name == "float32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)
    else:
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err < 1e-2, (what, err)


ACT_CASES = [(16, 1, "h", True), (64, 1, "w", False), (128, 8, "h", True),
             (128, 2, "w", False), (64, 16, "h", True), (16, 32, "w", False)]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,d,axis,act", ACT_CASES)
def test_packed_conv_act_matches_jax(C, d, axis, act, dtype_name):
    """Forward and dx / dk / db of `packed_conv_act` against JAX
    `conv_h_packed` / `conv_w_packed(pallas=True)`."""
    x, k, b, g = _inputs(C, C + d, dtype_name)
    kern4 = k[:, None] if axis == "h" else k[None]
    conv = pg.conv_h_packed if axis == "h" else pg.conv_w_packed

    def f(xx, kk, bb):
        return conv(xx, kk, bb, C, d, pallas=True, act=act)

    jx = _jax(x.reshape(B, H, W * C), dtype_name)
    jy, vjp = jax.vjp(f, jx, jnp.asarray(kern4), jnp.asarray(b))
    jdx, jdk, jdb = vjp(_jax(g.reshape(B, H, W * C), dtype_name))
    jdk = np.asarray(jdk).reshape(3, C, C)

    tx = _torch(x, dtype_name).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y = pc.packed_conv_act(tx, tk, tb, axis, d, act)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    _close(y, jy, dtype_name, "y", rtol=1e-5, atol=1e-5)
    y.backward(_torch(g, dtype_name))
    assert tx.grad.dtype == tx.dtype and tk.grad.dtype == torch.float32

    # the backward on JAX's y: the same relu mask on both sides
    ty = _torch(np.asarray(jy, np.float32), dtype_name).reshape(x.shape)
    dx, dk, db = pc.packed_conv_act_bwd_plain(
        tx.detach(), ty, _torch(g, dtype_name), tk.detach(), axis, d, act)
    assert dx.dtype == tx.dtype and dk.dtype == db.dtype == torch.float32
    for name, got, want in (("dx", dx, jdx), ("dk", dk, jdk),
                            ("db", db, jdb)):
        _close(got, want, dtype_name, name)
    # the autograd wrapper on a CPU tensor is that plain backward
    py = pc.packed_conv_act_fwd_plain(tx.detach(), tk.detach(), tb.detach(),
                                      axis, d, act)
    want = pc.packed_conv_act_bwd_plain(tx.detach(), py, _torch(g, dtype_name),
                                        tk.detach(), axis, d, act)
    for got, w in zip((tx.grad, tk.grad, tb.grad), want):
        assert torch.equal(got, w)


CONV_CASES = [(16, 1, "h"), (16, 1, "w"), (64, 1, "h"), (64, 1, "w"),
              (128, 4, "h"), (128, 16, "w"), (128, 16, "h"), (16, 32, "w")]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,d,axis", CONV_CASES)
def test_packed_conv_matches_jax(C, d, axis, dtype_name):
    """Forward (f32 out), dx and dk of `packed_conv` against JAX
    `packed_conv` (`_run_apply`, `_run_wgrad`)."""
    x, k, _, g = _inputs(C, 7 * C + d, dtype_name)
    s = d if axis == "h" else d * C

    def f(xx, kk):
        kexp = jnp.stack([pg._expand(kk[t], C) for t in range(3)])
        return jax_packed_conv(xx, kexp, axis, s)

    jx = _jax(x.reshape(B, H, W * C), dtype_name)
    jy, vjp = jax.vjp(f, jx, jnp.asarray(k))
    jdx, jdk = vjp(jnp.asarray(g.reshape(B, H, W * C)))

    tx = _torch(x, dtype_name).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    y = pc.packed_conv(tx, tk, axis, d)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jy).reshape(y.shape), rtol=1e-5,
                               atol=1e-5)
    y.backward(torch.from_numpy(g))
    assert tx.grad.dtype == tx.dtype and tk.grad.dtype == torch.float32
    _close(tx.grad, jdx, dtype_name, "dx")
    _close(tk.grad, jdk, dtype_name, "dk")


@pytest.mark.parametrize("C", [16, 64, 128])
def test_channel_sums_float32_matches_jax(C):
    """The moments of an NB1D BatchNorm on a float32 plane: the plain
    version against JAX's kernel, sums rtol 1e-5."""
    x = np.random.default_rng(C).normal(0.3, 1, (B, H, W, C)).astype(
        np.float32)
    sel = jnp.zeros((128, 128), jnp.float32).at[:, :C].set(
        jnp.asarray(pg._chan_select(C)))
    want = jax_channel_sums(jnp.asarray(x).reshape(B, H, W * C), sel, C,
                            True)[:, :C]
    got = pc.channel_sums(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_wrappers_launch_no_kernel_on_cpu_and_refuse_meta():
    x = torch.zeros(1, 4, 4, 16)
    k, b = torch.zeros(3, 16, 16), torch.zeros(16)
    before = [(f.launches, f.bwd_launches)
              for f in (pc.packed_conv_act, pc.packed_conv)]
    pc.packed_conv_act(x, k, b, "h", 1, True)
    pc.packed_conv(x, k, "w", 1)
    assert before == [(f.launches, f.bwd_launches)
                      for f in (pc.packed_conv_act, pc.packed_conv)]
    meta = torch.zeros(1, 4, 4, 16, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pc.packed_conv_act(meta, k, b, "h", 1, True)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        pc.packed_conv(meta.half(), k, "h", 1)


# ----------------------------------------------------------------------
# fused_blocks / fused_maps
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fused_blocks,fused_maps,blocks_on,maps_on", [
    (True, None, "nb_half", True), (False, None, "packed_conv_act", False),
    (False, True, "packed_conv_act", True), (True, False, "nb_half", False)])
def test_fused_maps_follows_fused_blocks(monkeypatch, fused_blocks,
                                         fused_maps, blocks_on, maps_on):
    """`fused_maps=None` takes the value of `fused_blocks` (JAX
    `_fused_maps_on`); an explicit value wins. Counted on the calls the
    backbone makes in one train-mode forward of `LaneNet.apply_packed`."""
    from lanedetection_end2end_tpu_torch.config import train_sh_config
    from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
    from lanedetection_end2end_tpu_torch.ops import packed_graph as tpg

    assert tpg.resolve_fused_maps(fused_blocks, fused_maps) == maps_on
    names = ("nb_half_a", "nb_half_b", "packed_conv_act", "channel_sums",
             "downsampler_op", "lane_maps_op", "head_rowsums_op")
    calls = dict.fromkeys(names, 0)
    for n in names:
        def counting(*a, _n=n, _f=getattr(tpg, n), **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(tpg, n, counting)
    net = LaneNet(train_sh_config(resize=32), device="cpu")
    images = torch.rand(1, 32, 64, 3,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = net.apply_packed(images, train=True, fused_blocks=fused_blocks,
                               fused_maps=fused_maps)
    assert torch.isfinite(out.beta).all()
    nb = 17 if blocks_on == "nb_half" else 0
    assert (calls["nb_half_a"], calls["nb_half_b"]) == (nb, nb)
    assert calls["packed_conv_act"] == 68 - 4 * nb
    assert calls["downsampler_op"] == (3 if maps_on else 0)
    assert calls["lane_maps_op"] == (2 if maps_on else 0)
    assert calls["head_rowsums_op"] == (1 if maps_on else 0)
    assert calls["channel_sums"] == (0 if nb else 34) + (0 if maps_on else 5)
