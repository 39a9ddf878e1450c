"""The port's fused NB1D half blocks (`ops/nb_block.py`) against the JAX
package's Pallas kernels (`ops/pallas_nb_block.py`, interpret mode) on the
CPU, in float32.

The same numpy inputs go through both. The JAX side gets its lane-packed
(B, H, W*C) plane, block-diagonal (3, 128, 128) taps and tiled biases
built from the same raw (3, C, C) taps and (C,) biases, inside the
differentiated function, so gradients come back in the raw layout. Bars
are the JAX package's own for these kernels (tests/test_fused_blocks.py):
outputs and moments atol 2e-4, rtol 1e-3; gradients atol 2e-3 * max|g|
over the whole gradient, rtol 2e-3, always with a non-zero moment
cotangent. The port side runs the plain versions, forward and explicit
backward, through the same autograd.Function the card path uses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.ops import packed_graph as pg
from lanedetection_end2end_tpu.ops import pallas_nb_block as jnb
from lanedetection_end2end_tpu_torch.models.erfnet import NonBottleneck1D
from lanedetection_end2end_tpu_torch.models.port import nb1d_state
from lanedetection_end2end_tpu_torch.ops import nb_block as nb
from lanedetection_end2end_tpu_torch.ops.packed_graph import nb1d_train
from test_torch_threads import one_torch_thread  # noqa: F401

# (C, d, H, W): the last is the resize-64 NB1D-128 plane, where d >= H, W
SHAPES = [(16, 1, 8, 32), (16, 2, 8, 32), (64, 1, 8, 8), (64, 2, 8, 8),
          (128, 16, 8, 16)]
IDS = [f"C{c}-d{d}-{h}x{w}" for c, d, h, w in SHAPES]
B = 2


def _inputs(C, H, W, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: rng.normal(0, scale, s).astype(np.float32)
    return {"x": f(B, H, W, C), "kh": f(3, C, C, scale=0.2),
            "bh": f(C, scale=0.1), "kw": f(3, C, C, scale=0.2),
            "bw": f(C, scale=0.1),
            "mul": rng.uniform(0.5, 1.5, C).astype(np.float32),
            "add": f(C, scale=0.1),
            # cotangents: of the plane, and (non-zero) of the moments
            "wy": f(B, H, W, C), "wm": f(2, C, scale=0.01)}


def _kexp(k, C):
    return jnp.stack([pg._expand(k[t], C) for t in range(3)])


def _tile(b, C):
    return pg._tile_lane(b, 128, C)[None]


def _jax_half(a, C, d, half):
    """(y, mom (2, C), grads) of sum(y*wy) + sum(mom*wm) in JAX."""
    names = (["x", "kh", "bh", "kw", "bw"] if half == "a" else
             ["x", "mul", "add", "kh", "bh", "kw", "bw"])

    def f(*args):
        p = dict(zip(names, args))
        Bx, H, W, _ = p["x"].shape
        plane = p["x"].reshape(Bx, H, W * C)
        if half == "a":
            y, mom = jnb.nb_half_a(plane, _kexp(p["kh"], C),
                                   _tile(p["bh"], C), _kexp(p["kw"], C),
                                   _tile(p["bw"], C), C, True)
        else:
            y, mom = jnb.nb_half_b(plane, _tile(p["mul"], C),
                                   _tile(p["add"], C), _kexp(p["kh"], C),
                                   _tile(p["bh"], C), _kexp(p["kw"], C),
                                   _tile(p["bw"], C), d, d * C, True)
        y = y.reshape(Bx, H, W, C)
        mom = mom[:, :C]
        return jnp.sum(y * a["wy"]) + jnp.sum(mom * a["wm"]), (y, mom)

    args = [jnp.asarray(a[n]) for n in names]
    (_, (y, mom)), grads = jax.value_and_grad(
        f, argnums=tuple(range(len(names))), has_aux=True)(*args)
    return (np.asarray(y), np.asarray(mom),
            {n: np.asarray(g) for n, g in zip(names, grads)})


def _torch_half(a, d, half, fn_a, fn_b, dtype=torch.float32):
    names = (["x", "kh", "bh", "kw", "bw"] if half == "a" else
             ["x", "mul", "add", "kh", "bh", "kw", "bw"])
    t = {n: torch.from_numpy(a[n]).clone().requires_grad_() for n in names}
    x = t["x"].to(dtype)
    if half == "a":
        y, mom = fn_a(x, t["kh"], t["bh"], t["kw"], t["bw"])
    else:
        y, mom = fn_b(x, t["mul"], t["add"], t["kh"], t["bh"], t["kw"],
                      t["bw"], d)
    loss = ((y.float() * torch.from_numpy(a["wy"])).sum()
            + (mom * torch.from_numpy(a["wm"])).sum())
    grads = torch.autograd.grad(loss, [t[n] for n in names])
    return (y.detach().float().numpy(), mom.detach().numpy(),
            {n: g.numpy() for n, g in zip(names, grads)})


def _compare_grads(got, want, tol=2e-3):
    gmax = max(float(np.abs(v).max()) for v in want.values())
    for n, v in want.items():
        np.testing.assert_allclose(got[n], v, atol=tol * gmax, rtol=tol,
                                   err_msg=n)


@pytest.mark.parametrize("C,H,W", [(16, 8, 32), (64, 8, 8), (128, 8, 16)])
def test_half_a_matches_jax(C, H, W):
    a = _inputs(C, H, W)
    y, mom, g = _torch_half(a, 1, "a", nb.nb_half_a, nb.nb_half_b)
    jy, jmom, jg = _jax_half(a, C, 1, "a")
    np.testing.assert_allclose(y, jy, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(mom, jmom, atol=2e-4, rtol=1e-3)
    _compare_grads(g, jg)


@pytest.mark.parametrize("C,d,H,W", SHAPES, ids=IDS)
def test_half_b_matches_jax(C, d, H, W):
    a = _inputs(C, H, W, seed=1)
    y, mom, g = _torch_half(a, d, "b", nb.nb_half_a, nb.nb_half_b)
    jy, jmom, jg = _jax_half(a, C, d, "b")
    np.testing.assert_allclose(y, jy, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(mom, jmom, atol=2e-4, rtol=1e-3)
    _compare_grads(g, jg)


@pytest.mark.parametrize("half", ["a", "b"])
@pytest.mark.parametrize("C,d,H,W", SHAPES, ids=IDS)
def test_plain_backward_matches_autograd(C, d, H, W, half):
    """The explicit plain backward (the kernels' order of operations)
    against torch.autograd of the plain forward, float32: they differ only
    by summation order."""
    a = _inputs(C, H, W, seed=2)
    _, _, g = _torch_half(a, d, half, nb.nb_half_a, nb.nb_half_b)
    _, _, ag = _torch_half(a, d, half, nb.nb_half_a_plain,
                           nb.nb_half_b_plain)
    _compare_grads(g, ag, tol=1e-5)


@pytest.mark.parametrize("half", ["a", "b"])
def test_bf16_plain_versions_agree(half):
    """On bf16 planes the explicit backward rounds the gradients to bf16
    where the kernels do, autograd of the plain forward does not: the two
    agree to a few bf16 steps (2^-8 each) of the largest gradient, and the
    outputs are bf16 with f32 moments."""
    C, d, H, W = 16, 2, 8, 32
    a = _inputs(C, H, W, seed=3)
    y, mom, g = _torch_half(a, d, half, nb.nb_half_a, nb.nb_half_b,
                            torch.bfloat16)
    _, _, ag = _torch_half(a, d, half, nb.nb_half_a_plain,
                           nb.nb_half_b_plain, torch.bfloat16)
    fy, fmom, _ = _torch_half(a, d, half, nb.nb_half_a, nb.nb_half_b)
    assert mom.dtype == np.float32
    assert np.abs(y - fy).max() <= 2e-2 * np.abs(fy).max()
    np.testing.assert_allclose(mom, fmom, rtol=2e-2,
                               atol=2e-2 * np.abs(fmom).max())
    _compare_grads(g, ag, tol=2e-2)


def _block_params(rng, C):
    conv = lambda shape: {
        "kernel": rng.normal(0, 0.2, shape).astype(np.float32),
        "bias": rng.normal(0, 0.1, C).astype(np.float32)}
    params = {"conv3x1_1": conv((3, 1, C, C)), "conv1x3_1": conv((1, 3, C, C)),
              "conv3x1_2": conv((3, 1, C, C)), "conv1x3_2": conv((1, 3, C, C)),
              "bn1": {"scale": rng.uniform(0.8, 1.2, C).astype(np.float32),
                      "bias": rng.normal(0, 0.1, C).astype(np.float32)},
              "bn2": {"scale": rng.uniform(0.8, 1.2, C).astype(np.float32),
                      "bias": rng.normal(0, 0.1, C).astype(np.float32)}}
    stats = {k: {"mean": rng.normal(0, 0.1, C).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
             for k in ("bn1", "bn2")}
    return params, stats


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("C,d,H,W", [(16, 2, 8, 32), (64, 1, 8, 8),
                                     (128, 16, 8, 16)])
def test_block_matches_jax_nb1d_packed(monkeypatch, C, d, H, W, train):
    """One whole block, `nb1d_train`, against `nb1d_packed` on the fused
    Pallas kernels: output, gradients of every parameter, and the new
    running statistics (biased variance, momentum 0.9)."""
    monkeypatch.setenv("PACKED_FUSED_BLOCKS", "1")
    monkeypatch.delenv("PACKED_BANDED", raising=False)
    rng = np.random.default_rng(4)
    params, stats = _block_params(rng, C)
    x = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)

    def f(p):
        y, ns = pg.nb1d_packed(jnp.asarray(x).reshape(B, H, W * C), p, stats,
                               C=C, d=d, train=train, drop=0.0, rng=None,
                               pallas=True)
        return jnp.sum(y ** 2), (y, ns)

    (_, (jy, jns)), jg = jax.value_and_grad(f, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))

    block = NonBottleneck1D(C, d)
    block.load_state_dict({k[len("b."):]: v for k, v in
                           nb1d_state(params, stats, "b").items()})
    y = nb1d_train(torch.from_numpy(x), block, train=train)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jy).reshape(B, H, W, C),
                               atol=2e-4, rtol=1e-3)
    for bn in ("bn1", "bn2"):
        mod = getattr(block, bn)
        np.testing.assert_allclose(mod.running_mean.numpy(),
                                   np.asarray(jns[bn]["mean"]), atol=1e-5)
        np.testing.assert_allclose(mod.running_var.numpy(),
                                   np.asarray(jns[bn]["var"]), atol=1e-5)
    gmax = max(float(np.abs(np.asarray(v)).max())
               for v in jax.tree_util.tree_leaves(jg))
    for conv, axis in (("conv3x1_1", 0), ("conv1x3_1", 1), ("conv3x1_2", 0),
                       ("conv1x3_2", 1)):
        w = getattr(block, conv).weight.grad.numpy()     # (O, I, kH, kW)
        np.testing.assert_allclose(w.transpose(2, 3, 1, 0),
                                   np.asarray(jg[conv]["kernel"]),
                                   atol=2e-3 * gmax, rtol=2e-3, err_msg=conv)
        # a bias ahead of a train-mode BatchNorm has true gradient ~ 0:
        # absolute tolerance
        np.testing.assert_allclose(getattr(block, conv).bias.grad.numpy(),
                                   np.asarray(jg[conv]["bias"]),
                                   atol=2e-3 * gmax, err_msg=conv)
    for bn in ("bn1", "bn2"):
        np.testing.assert_allclose(getattr(block, bn).weight.grad.numpy(),
                                   np.asarray(jg[bn]["scale"]),
                                   atol=2e-3 * gmax, rtol=2e-3, err_msg=bn)
        np.testing.assert_allclose(getattr(block, bn).bias.grad.numpy(),
                                   np.asarray(jg[bn]["bias"]),
                                   atol=2e-3 * gmax, rtol=2e-3, err_msg=bn)


def test_cpu_tensors_launch_no_kernel_and_other_devices_raise():
    counts = lambda: [nb.nb_half_a.launches, nb.nb_half_a.bwd_launches,
                      nb.nb_half_b.launches, nb.nb_half_b.bwd_launches]
    before = counts()
    a = _inputs(16, 8, 32)
    _torch_half(a, 1, "a", nb.nb_half_a, nb.nb_half_b)
    _torch_half(a, 2, "b", nb.nb_half_a, nb.nb_half_b)
    assert counts() == before
    x = torch.zeros(1, 8, 8, 16, dtype=torch.bfloat16, device="meta")
    k, b = torch.zeros(3, 16, 16), torch.zeros(16)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        nb.nb_half_a(x, k, b, k, b)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        nb.nb_half_b(x, b, b, k, b, k, b, 2)
