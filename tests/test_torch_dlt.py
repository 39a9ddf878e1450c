"""The learned homography's parts, the port against the JAX package on the
CPU: the DLT solve (`geometry/dlt.py`), `HomographyHead`, the per-sample
fit (`WLSFitter.sep_coeff_from_M` / `fit_with_M`), the per-sample
backprojection loss (`BackprojectionLoss.with_M`) and projection
(`Projections.compute_coordinates_with_M`), the weight carrier with the
head, and ERFNet's dormant `do_segmentation` decoder. Resize 32 unless
said, seeds from numpy, JAX eager on the CPU as `tests/test_dlt.py` runs
it.

Bars, each measured on this host:
- The DLT system is badly conditioned (cond(A) 2.8e4 at resize 32, 1.9e6
  at resize 256), so each package's float32 LU is held against a float64
  solve of the same system (the witness), and the two against each
  other, at 1e-4 of max|witness| for M and M_inv. Read: port 2.3e-7 to
  2.9e-6 (M) and 3.0e-6 to 9.7e-6 (M_inv), JAX 1.7e-7 to 3.1e-6 and
  2.8e-6 to 9.1e-6, port against JAX up to 1.1e-5, at resize 32, 64
  and 256. The control, the same float32 solve with A and b rounded to
  TF32 first, reads 4.0e-3 to 1.6e-2 and must read above the bar.
- `HomographyHead`: eval and train mode outputs at 1e-6 absolute (they
  lie in (-1/16, 1/16)); new running statistics at 1e-5.
- The fit, the loss and the projection are float32 on both sides in
  another summation order. The fit's cubic solve amplifies that: beta
  per coefficient column at 2e-3 of the column's max (read up to 7.4e-4
  port against JAX over three seeds; against a float64 fit the port
  reads up to 3.0e-4, JAX up to 6.7e-4), the bar of the whole-step beta
  (tests/test_torch_train_step.py); the loss, x_cal and the projection
  at rtol 1e-4, gradients at 1e-3 of their max. The contractions must
  call no matmul (TF32 would reach one on a card) and stay within 1e-5
  of a float64 evaluation, where a TF32 rounding of their operands reads
  above 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.eval.projections import (
    Projections as JaxProjections)
from lanedetection_end2end_tpu.geometry import (
    bev_matrices_pixel as jax_bev_pixel)
from lanedetection_end2end_tpu.geometry.dlt import (
    dlt_anchor_points as jax_anchors, dlt_homography as jax_dlt)
from lanedetection_end2end_tpu.models.dlt import (
    HomographyHead as JaxHomographyHead)
from lanedetection_end2end_tpu.models.erfnet import ERFNet as JaxERFNet
from lanedetection_end2end_tpu.ops.losses import (
    BackprojectionLoss as JaxBackprojectionLoss)
from lanedetection_end2end_tpu.ops.wls import WLSFitter as JaxWLSFitter
from lanedetection_end2end_tpu_torch.eval.projections import Projections
from lanedetection_end2end_tpu_torch.geometry import (
    bev_matrices_pixel, dlt_anchor_points, dlt_homography)
from lanedetection_end2end_tpu_torch.geometry.dlt import (
    dlt_matrices, dlt_system)
from lanedetection_end2end_tpu_torch.models.dlt import HomographyHead
from lanedetection_end2end_tpu_torch.models.erfnet import ERFNet
from lanedetection_end2end_tpu_torch.models.port import (
    state_dict_from_variables, variables_from_state_dict)
from lanedetection_end2end_tpu_torch.ops.losses import BackprojectionLoss
from lanedetection_end2end_tpu_torch.ops.tf32x3 import round_tf32
from lanedetection_end2end_tpu_torch.ops.wls import WLSFitter

RESIZE, BATCH = 32, 3
DLT_TOL = 1e-4


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def witness(offsets, resize):
    """The DLT system solved in float64 on float64 offsets."""
    A, b = dlt_system(torch.from_numpy(np.float64(offsets)), resize)
    return [t.numpy() for t in dlt_matrices(torch.linalg.solve(A, b))]


def tf32_control(offsets, resize):
    """The float32 solve with A and b rounded to TF32 first."""
    A, b = dlt_system(torch.from_numpy(offsets), resize)
    h = torch.linalg.solve(round_tf32(A), round_tf32(b))
    return [t.numpy() for t in dlt_matrices(h)]


DLT_CASES = [(32, "zero"), (32, "seeded"), (256, "seeded")]


@pytest.mark.parametrize("resize,kind", DLT_CASES,
                         ids=[f"{r}-{k}" for r, k in DLT_CASES])
def test_dlt_homography_matches_jax_and_the_float64_witness(resize, kind):
    off = (np.zeros((4, 3), np.float32) if kind == "zero" else
           np.random.default_rng(resize).uniform(
               -1 / 16, 1 / 16, (4, 3)).astype(np.float32))
    M, M_inv = [t.numpy() for t in dlt_homography(torch.from_numpy(off),
                                                  resize)]
    jM, jM_inv = [np.asarray(t) for t in jax_dlt(jnp.asarray(off), resize)]
    wM, wM_inv = witness(off, resize)
    cM, cM_inv = tf32_control(off, resize)
    assert M.dtype == M_inv.dtype == np.float32
    assert M.shape == M_inv.shape == (4, 3, 3)
    for got, want, w, c in ((M, jM, wM, cM), (M_inv, jM_inv, wM_inv,
                                              cM_inv)):
        assert rel(got, w) < DLT_TOL
        assert rel(want, w) < DLT_TOL
        assert rel(got, want) < DLT_TOL
        assert rel(c, w) > DLT_TOL  # the control sits above the bar
    # the row-separable structure, exactly
    assert (M[:, 1, 0] == 0).all() and (M[:, 2, 0] == 0).all()
    assert (M[:, 2, 2] == 1).all() and (M_inv[:, 2, 2] == 1).all()
    if kind == "zero":
        fixed, fixed_inv = bev_matrices_pixel(resize)
        np.testing.assert_allclose(fixed, jax_bev_pixel(resize)[0])
        for i in range(4):
            assert rel(M[i], fixed) < DLT_TOL
            assert rel(M_inv[i], fixed_inv) < DLT_TOL


def test_dlt_anchor_points_and_offsets_move_the_anchors():
    for r in (32, 256):
        for a, b in zip(dlt_anchor_points(r), jax_anchors(r)):
            np.testing.assert_array_equal(a, b)
    off = np.float32([[0.01, -0.02, 0.015]])
    M = dlt_homography(torch.from_numpy(off), RESIZE)[0][0].double().numpy()
    src, dst = dlt_anchor_points(RESIZE)
    w = 2 * RESIZE
    want = dst + np.array([[0.01 * w, 0.015 * RESIZE],
                           [-0.02 * w, 0.015 * RESIZE],
                           [0.01 * w, 0.0], [-0.02 * w, 0.0]])
    hom = M @ np.concatenate([src, np.ones((4, 1))], 1).T
    np.testing.assert_allclose((hom[:2] / hom[2]).T, want, atol=1e-3)


def test_dlt_homography_gradient_matches_jax():
    off = np.random.default_rng(7).uniform(-0.03, 0.03, (2, 3)).astype(
        np.float32)
    r = np.random.default_rng(8)
    cM, cMi = r.normal(size=(2, 3, 3)), r.normal(size=(2, 3, 3))

    def jloss(o):
        M, Mi = jax_dlt(o, RESIZE)
        return jnp.sum(M * cM) + jnp.sum(Mi * cMi)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(off)))
    t = torch.from_numpy(off).requires_grad_()
    M, Mi = dlt_homography(t, RESIZE)
    ((M * torch.from_numpy(cM).float()).sum()
     + (Mi * torch.from_numpy(cMi).float()).sum()).backward()
    assert rel(t.grad.numpy(), want) < 1e-3


# ----------------------------------------------------------------------
# HomographyHead
# ----------------------------------------------------------------------

def seeded_head(seed=0):
    """The port's head with seeded weights, fc_offsets non-zero, and
    BatchNorm away from identity; -> (head, JAX variables)."""
    g = torch.Generator().manual_seed(seed)
    head = HomographyHead()
    with torch.no_grad():
        for name, t in head.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif name.endswith("_bn.weight"):
                t.copy_(0.8 + 0.4 * torch.rand(t.shape, generator=g))
            else:
                fan = t[0].numel() if t.dim() > 1 else 10
                t.copy_(torch.randn(t.shape, generator=g) / fan ** 0.5)
    named = {f"homography_head.{k}": v for k, v in head.state_dict().items()}
    tree = variables_from_state_dict(named, RESIZE)
    return head, {c: tree[c]["homography_head"] for c in tree}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_homography_head_matches_jax(train):
    head, v = seeded_head()
    x = np.random.default_rng(1).normal(
        size=(BATCH, RESIZE // 8, RESIZE // 4, 128)).astype(np.float32)
    mod = JaxHomographyHead()
    if train:
        want, upd = mod.apply(v, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    else:
        want = mod.apply(v, jnp.asarray(x), train=False)
    head.train(train)
    with torch.no_grad():
        got = head(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (BATCH, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert np.abs(np.asarray(want)).max() > 1e-3  # the offsets move
    if train:
        named = {f"homography_head.{k}": t
                 for k, t in head.state_dict().items()}
        stats = variables_from_state_dict(named, RESIZE)["batch_stats"]
        for name, s in upd["batch_stats"].items():
            for k in ("mean", "var"):
                np.testing.assert_allclose(
                    stats["homography_head"][name][k], np.asarray(s[k]),
                    atol=1e-5, err_msg=f"{name}/{k}")


def test_homography_head_starts_at_zero_offsets():
    head = HomographyHead().eval()
    assert not head.fc_offsets.weight.any() and not head.fc_offsets.bias.any()
    x = torch.randn(2, 128, 4, 8)
    assert (head(x) == 0).all()


# ----------------------------------------------------------------------
# The per-sample fit, loss and projection
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def fit_inputs():
    rng = np.random.default_rng(3)
    H, W = RESIZE, 2 * RESIZE
    wmaps = rng.uniform(0, 1, (BATCH, H, W, 4)).astype(np.float32)
    wmaps[:, :7] = 0.0  # the row mask
    off = rng.uniform(-0.03, 0.03, (BATCH, 3)).astype(np.float32)
    M_b, M_inv_b = [np.array(t) for t in jax_dlt(jnp.asarray(off),
                                                   RESIZE)]
    M, _ = bev_matrices_pixel(RESIZE)
    fitter = WLSFitter(M, H, W, 3, normalized=False, reg_ls=1.0,
                       device="cpu")
    jfitter = JaxWLSFitter(M, H, W, 3, normalized=False, reg_ls=1.0,
                           use_pallas=False)
    return wmaps, M_b, M_inv_b, fitter, jfitter, rng


def test_sep_coeff_from_M_matches_jax(fit_inputs):
    _, M_b, _, fitter, jfitter, _ = fit_inputs
    got = fitter.sep_coeff_from_M(torch.from_numpy(M_b)).numpy()
    want = np.asarray(jfitter.sep_coeff_from_M(jnp.asarray(M_b)))
    assert got.shape == want.shape == (BATCH, 2 * RESIZE, 20)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    # at the fixed matrix, the constant rows of __init__
    M = torch.from_numpy(np.float32(bev_matrices_pixel(RESIZE)[0]))[None]
    np.testing.assert_allclose(fitter.sep_coeff_from_M(M)[0].numpy(),
                               fitter.sep_coeff.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_fit_with_M_value_and_gradients_match_jax(fit_inputs):
    wmaps, M_b, _, fitter, jfitter, rng = fit_inputs
    cot = rng.normal(size=(BATCH, 4, 4)).astype(np.float32)
    # the coefficients span orders of magnitude: weigh each column alike
    scale = np.asarray(jfitter.fit_with_M(jnp.asarray(wmaps),
                                          jnp.asarray(M_b))).std((0, 1))
    cot = cot / scale

    def jloss(w, m):
        return jnp.sum(jfitter.fit_with_M(w, m, layout="nhwc") * cot)

    want = np.asarray(jfitter.fit_with_M(jnp.asarray(wmaps),
                                         jnp.asarray(M_b)))
    jgw, jgm = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(wmaps),
                                               jnp.asarray(M_b))
    w = torch.from_numpy(wmaps).requires_grad_()
    m = torch.from_numpy(M_b).requires_grad_()
    beta = fitter.fit_with_M(w, m)
    (beta * torch.from_numpy(cot)).sum().backward()
    got = beta.detach().numpy()
    assert got.shape == (BATCH, 4, 4)
    for i in range(4):  # per coefficient column
        assert rel(got[..., i], want[..., i]) < 2e-3, i
    assert rel(w.grad.numpy(), np.asarray(jgw)) < 1e-3
    assert rel(m.grad.numpy(), np.asarray(jgm)) < 1e-3
    assert np.abs(m.grad.numpy()).max() > 0


def test_fit_with_M_at_the_fixed_matrix_is_the_constant_fit(fit_inputs):
    wmaps, _, _, fitter, _, _ = fit_inputs
    M = np.float32(bev_matrices_pixel(RESIZE)[0])
    M_b = torch.from_numpy(np.tile(M[None], (BATCH, 1, 1)))
    w = torch.from_numpy(wmaps)
    got, want = fitter.fit_with_M(w, M_b).numpy(), fitter(w).numpy()
    for i in range(4):
        assert rel(got[..., i], want[..., i]) < 2e-4, i


def test_backprojection_with_M_value_and_gradient_match_jax(fit_inputs):
    _, M_b, M_inv_b, _, _, rng = fit_inputs
    crit = BackprojectionLoss(RESIZE, 3, device="cpu")
    jcrit = JaxBackprojectionLoss(RESIZE, 3)
    params = np.stack([rng.normal(0, 1e-4, BATCH), rng.normal(0, 1e-2, BATCH),
                       rng.normal(0, 0.5, BATCH),
                       rng.uniform(20, 40, BATCH)], -1).astype(np.float32)
    x_gt = rng.uniform(0, 2 * RESIZE, (BATCH, 56)).astype(np.float32)
    valid = (rng.uniform(size=(BATCH, 56)) > 0.3).astype(np.float32)

    def jloss(p, m, mi):
        return jcrit.with_M(p, jnp.asarray(x_gt), jnp.asarray(valid), m,
                            mi)[0]

    jl, jx = jcrit.with_M(jnp.asarray(params), jnp.asarray(x_gt),
                          jnp.asarray(valid), jnp.asarray(M_b),
                          jnp.asarray(M_inv_b))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(params), jnp.asarray(M_b), jnp.asarray(M_inv_b))
    ts = [torch.from_numpy(a).requires_grad_()
          for a in (params, M_b, M_inv_b)]
    loss, x_cal = crit.with_M(ts[0], torch.from_numpy(x_gt),
                              torch.from_numpy(valid), ts[1], ts[2])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    np.testing.assert_allclose(x_cal.detach().numpy(), np.asarray(jx),
                               rtol=1e-4, atol=1e-4 * np.abs(jx).max())
    for t, want in zip(ts, jg):
        # the gradient of params per coefficient column, as beta's
        g, want = t.grad.numpy(), np.asarray(want)
        if g.ndim == 2:
            for i in range(g.shape[1]):
                assert rel(g[:, i], want[:, i]) < 1e-3, i
        else:
            assert rel(g, want) < 1e-3
    # at the fixed matrices, the constant loss
    M, Mi = [torch.from_numpy(np.tile(np.float32(a)[None], (BATCH, 1, 1)))
             for a in bev_matrices_pixel(RESIZE)]
    args = (torch.from_numpy(params), torch.from_numpy(x_gt),
            torch.from_numpy(valid))
    np.testing.assert_allclose(crit.with_M(*args, M, Mi)[0].item(),
                               crit(*args)[0].item(), rtol=1e-4)


def test_compute_coordinates_with_M_matches_jax(fit_inputs):
    _, M_b, M_inv_b, _, _, rng = fit_inputs
    beta = np.stack([rng.normal(0, 1e-4, (BATCH, 4)),
                     rng.normal(0, 1e-2, (BATCH, 4)),
                     rng.normal(0, 0.5, (BATCH, 4)),
                     rng.uniform(10, 50, (BATCH, 4))], -1).astype(np.float32)
    got = Projections(RESIZE, 3, device="cpu").compute_coordinates_with_M(
        torch.from_numpy(beta), torch.from_numpy(M_b),
        torch.from_numpy(M_inv_b)).numpy()
    want = np.asarray(JaxProjections(RESIZE, 3).compute_coordinates_with_M(
        jnp.asarray(beta), jnp.asarray(M_b), jnp.asarray(M_inv_b)))
    assert got.shape == want.shape == (BATCH, 4, 56)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    # at the fixed matrices, the constant projection
    M, Mi = [torch.from_numpy(np.tile(np.float32(a)[None], (BATCH, 1, 1)))
             for a in bev_matrices_pixel(RESIZE)]
    p = Projections(RESIZE, 3, device="cpu")
    np.testing.assert_allclose(
        p.compute_coordinates_with_M(torch.from_numpy(beta), M, Mi).numpy(),
        p.compute_coordinates(torch.from_numpy(beta)).numpy(), rtol=1e-4,
        atol=1e-4 * np.abs(want).max())


def test_per_sample_contractions_call_no_matmul(fit_inputs, monkeypatch):
    """TF32 cannot reach the per-sample contractions: they multiply
    element-wise and sum, in float32 (y_eval^3 reaches about 1.4e9 at
    resize 256). A matmul or einsum there would follow
    `torch.backends.cuda.matmul.allow_tf32` on a card; here any call of
    one fails the test, forward and backward."""
    wmaps, M_b, M_inv_b, fitter, _, _ = fit_inputs

    def refuse(*a, **k):
        raise AssertionError("a matmul reached a per-sample contraction")

    w = torch.from_numpy(wmaps).requires_grad_()
    m = torch.from_numpy(M_b).requires_grad_()
    mi = torch.from_numpy(M_inv_b).requires_grad_()
    crit = BackprojectionLoss(RESIZE, 3, device="cpu")
    proj = Projections(RESIZE, 3, device="cpu")
    valid = torch.ones(BATCH, 56)
    with monkeypatch.context() as mp:
        for name in ("einsum", "matmul", "bmm", "mm", "tensordot"):
            mp.setattr(torch, name, refuse)
        mp.setattr(torch.Tensor, "__matmul__", refuse)
        beta = fitter.fit_with_M(w, m)
        loss = sum(crit.with_M(beta[:, k], valid * 30, valid, m, mi)[0]
                   for k in range(4))
        x = proj.compute_coordinates_with_M(beta, m, mi)
        (loss + x.sum()).backward()
    assert torch.isfinite(w.grad).all() and torch.isfinite(m.grad).all()


def test_per_sample_contractions_hold_float32_where_tf32_would_not():
    """At resize 256 `with_M`'s float32 x_cal is within 1e-5 of the same
    formula in float64 (relative to max|x_cal|; read 1.4e-6); with the
    contraction's operands rounded to TF32 first it reads above 1e-4
    (read 8.9e-4)."""
    rng = np.random.default_rng(5)
    r = 256
    crit = BackprojectionLoss(r, 3, device="cpu")
    M, Mi = [torch.from_numpy(np.tile(np.float32(a)[None], (2, 1, 1)))
             for a in bev_matrices_pixel(r)]
    params = torch.from_numpy(np.stack(
        [rng.normal(0, 1e-6, 2), rng.normal(0, 1e-3, 2),
         rng.normal(0, 0.3, 2), rng.uniform(200, 300, 2)], -1)).float()
    ones = torch.ones(2, 56)
    got = crit.with_M(params, ones, ones, M, Mi)[1]
    Md, Mid = M.double(), Mi.double()
    y_d = crit.y_d.double()[None]
    y_prime = (Md[:, 1, 1:2] * y_d + Md[:, 1, 2:3]) / (
        Md[:, 2, 1:2] * y_d + Md[:, 2, 2:3])
    y_eval = (r - 1.0) - y_prime
    Yb = torch.stack([y_eval ** 3, y_eval ** 2, y_eval,
                      torch.ones_like(y_eval)], -1)

    def x_cal(p, Y):
        xp = (p.double()[:, None, :] * Y.double()).sum(-1)
        return ((Mid[:, 0, 0:1] * xp + Mid[:, 0, 1:2] * y_prime
                 + Mid[:, 0, 2:3]) / (Mid[:, 2, 0:1] * xp
                                      + Mid[:, 2, 1:2] * y_prime
                                      + Mid[:, 2, 2:3]))

    exact = x_cal(params, Yb)
    tf32 = x_cal(round_tf32(params), round_tf32(Yb.float()))
    assert Yb.abs().max() > 1e7
    assert rel(got.numpy(), exact.numpy()) < 1e-5
    assert rel(tf32.numpy(), exact.numpy()) > 1e-4


# ----------------------------------------------------------------------
# The weight carrier and ERFNet's do_segmentation decoder
# ----------------------------------------------------------------------

def test_carrier_round_trips_the_homography_head():
    head, v = seeded_head(2)
    variables = {"params": {"homography_head": v["params"]},
                 "batch_stats": {"homography_head": v["batch_stats"]}}
    # the carrier's forward direction needs an erfnet; carry the head
    # through the inverse and back through a whole LaneNet tree
    from lanedetection_end2end_tpu_torch.config import train_sh_config
    from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
    cfg = train_sh_config(resize=RESIZE, learn_homography=True)
    net = LaneNet(cfg, device="cpu")
    net.homography_head.load_state_dict(head.state_dict())
    tree = variables_from_state_dict(net.state_dict(), RESIZE)
    for coll in ("params", "batch_stats"):
        for name, leaves in variables[coll]["homography_head"].items():
            for k, a in leaves.items():
                np.testing.assert_array_equal(
                    tree[coll]["homography_head"][name][k], a)
    # flax layouts: Dense (in, out), conv (kh, kw, in, out)
    p = tree["params"]["homography_head"]
    assert p["fc_offsets"]["kernel"].shape == (128, 3)
    assert p["conv2"]["kernel"].shape == (3, 3, 128, 128)
    sd = state_dict_from_variables(tree)
    assert set(sd) == set(net.state_dict())
    for k, t in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], t), k
    # a leaf with no place still raises
    tree["params"]["homography_head"]["fc_extra"] = {"kernel": np.zeros(1)}
    with pytest.raises(ValueError, match="no place"):
        state_dict_from_variables(tree)


@pytest.fixture(scope="module")
def erfnet_seg():
    """The port's ERFNet with `do_segmentation`, seeded weights with
    BatchNorm statistics away from (0, 1), and the same in JAX's layout."""
    g = torch.Generator().manual_seed(4)
    with torch.random.fork_rng():
        torch.manual_seed(4)
        net = ERFNet(4, do_segmentation=True).eval()
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif name.endswith("running_mean"):
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
    tree = variables_from_state_dict(
        {f"net.{k}": t for k, t in net.state_dict().items()}, RESIZE)
    return net, {c: tree[c]["erfnet"] for c in tree}


def test_erfnet_do_segmentation_matches_jax(erfnet_seg):
    net, v = erfnet_seg
    assert set(v["params"]) == {"encoder", "decoder", "decoder_seg"}
    x = np.random.default_rng(6).uniform(
        0, 1, (2, RESIZE, 2 * RESIZE, 3)).astype(np.float32)
    jnet = JaxERFNet(out_channels=4, do_segmentation=True)
    enc, dec, seg = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        tenc, tdec, tseg = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tseg.shape == (2, 5, RESIZE, 2 * RESIZE)
    for got, want in ((tenc, enc), (tdec, dec), (tseg, seg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # without the flag, the encoder features stand in for seg
    plain = ERFNet(4).eval()
    e, _, s = plain(torch.zeros(1, 3, RESIZE, 2 * RESIZE))
    assert s is e and not hasattr(plain, "decoder_seg")


def test_carrier_names_the_decoder_seg_leaves(erfnet_seg):
    net, v = erfnet_seg
    sd = state_dict_from_variables({"params": {"erfnet": v["params"]},
                                    "batch_stats": {"erfnet":
                                                    v["batch_stats"]}})
    seg = {k for k in sd if k.startswith("net.decoder_seg.")}
    assert seg == {f"net.{k}" for k in net.state_dict()
                   if k.startswith("decoder_seg.")}
    assert "net.decoder_seg.output_conv.weight" in seg
    assert sd["net.decoder_seg.output_conv.weight"].shape == (16, 5, 2, 2)
    for k in seg:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], net.state_dict()[k[4:]]), k
