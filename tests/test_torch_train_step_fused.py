"""The slice as a whole in the JAX package's default configuration: one e2e
train step of the port with `fused_maps=True` against the JAX package's
with PACKED_PALLAS=1, PACKED_FUSED_BLOCKS=1, PACKED_FUSED_MAPS=1 on the CPU.

Everything else is tests/test_torch_train_step.py's: the config
`train_sh_config(resize=32, batch_size=2, reg_ls=1.0)`, the weights, the
compact batch, dropout off, and the bars with their reasons (float32: head
losses rtol 1e-4, total loss and beta 2e-3, whole gradient cosine > 0.999
and norm ratio 0.98-1.02, leaves next to the loss 2e-3 * max|g| and every
other leaf 5e-2 * max|g|, new running statistics atol 1e-4; bfloat16: beta
3e-2 of max, losses rtol 6e-2). Here the downsamplers, the upsamplers and
the fused head + row-sum tail run on the Pallas lane-map kernels in
interpret mode on the JAX side and on the plain versions of
`ops/lanemaps.py` on the port's, and neither side forms the logits in the
train step."""

import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
from lanedetection_end2end_tpu_torch.ops.packed_conv import channel_sums
from test_torch_train_step import BATCH, NEAR_LOSS, RESIZE, run_both
from test_torch_threads import one_torch_thread  # noqa: F401

OPS = (lm.downsampler_op, lm.lane_maps_op, lm.head_rowsums_op)


@pytest.fixture(scope="module")
def f32():
    before = [(f.launches, f.bwd_launches) for f in OPS]
    out = run_both("float32", fused_maps=True)
    out["op_counts"] = (before, [(f.launches, f.bwd_launches) for f in OPS])
    return out


@pytest.fixture(scope="module")
def bf16():
    return run_both("bfloat16", with_grads=False, fused_maps=True)


@pytest.mark.parametrize("key,rtol", [
    ("loss", 2e-3), ("loss_line", 1e-4), ("loss_horizon", 1e-4),
    ("acc_line", 1e-6), ("acc_horizon", 1e-6)])
def test_fused_step_metrics_match_jax(f32, key, rtol):
    np.testing.assert_allclose(f32["metrics"][key], f32["jmetrics"][key],
                               rtol=rtol)


def test_fused_train_mode_beta_matches_jax(f32):
    got, want = f32["beta"], f32["jbeta"]
    assert got.shape == want.shape == (BATCH, 4, 4)
    bound = 2e-3 * (np.abs(want) + np.abs(want).max(axis=(0, 1)))
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max((0, 1))


def test_fused_whole_gradient_matches_jax(f32):
    g, jg = f32["grads"], f32["jgrads"]
    used = [k for k in jg if np.abs(jg[k]).max() > 0]
    assert set(g) == set(used)
    dot = sum(float((g[k] * jg[k]).sum()) for k in used)
    n1 = np.sqrt(sum(float((g[k] ** 2).sum()) for k in used))
    n2 = np.sqrt(sum(float((jg[k] ** 2).sum()) for k in used))
    assert dot / (n1 * n2) > 0.999, dot / (n1 * n2)
    assert 0.98 < n1 / n2 < 1.02, n1 / n2


def test_fused_gradient_leaves_match_jax(f32):
    g, jg = f32["grads"], f32["jgrads"]
    gmax = max(float(np.abs(v).max()) for v in jg.values())
    near = 0
    for k in g:
        assert g[k].shape == jg[k].shape, k
        tol = 2e-3 if k.startswith(NEAR_LOSS) else 5e-2
        near += k.startswith(NEAR_LOSS)
        np.testing.assert_allclose(g[k], jg[k], atol=tol * gmax, rtol=tol,
                                   err_msg=k)
    assert near == 6


def test_fused_new_running_stats_match_jax(f32):
    assert set(f32["stats"]) == set(f32["jstats"])
    for k, want in f32["jstats"].items():
        np.testing.assert_allclose(f32["stats"][k], want, atol=1e-4,
                                   err_msg=k)


def test_fused_step_state_and_no_kernel_launch_on_cpu(f32):
    """On CPU tensors every wrapper takes its plain version: no counter of
    the lane-map ops or of `channel_sums` moves over the steps."""
    before, after = f32["op_counts"]
    assert before == after
    assert channel_sums.launches == f32["counts"][2]
    assert f32["step"].state.step == 1


def test_fused_eval_step_outputs(f32):
    out = f32["eval_out"]
    assert out["beta"].shape == (BATCH, 4, 4)
    assert out["horizon_pred"].shape == (BATCH, RESIZE)
    assert all(torch.isfinite(t.float()).all() for t in out.values())


@pytest.mark.parametrize("key", ["loss", "loss_line", "loss_horizon"])
def test_fused_bf16_step_matches_jax(bf16, key):
    np.testing.assert_allclose(bf16["metrics"][key], bf16["jmetrics"][key],
                               rtol=6e-2)


def test_fused_bf16_beta_matches_jax(bf16):
    got, want = bf16["beta"], bf16["jbeta"]
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() / np.abs(want).max() < 3e-2


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_fused_path_matches_unfused_port_path(train):
    """`apply_packed` with fused maps against the same call without, on the
    same weights: beta, the heads and the encoder features; the train-mode
    fused tail forms no logits, the eval step's head does, and they agree
    with the unfused ones."""
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0)
    torch.manual_seed(0)
    a, b = LaneNet(cfg, device="cpu"), LaneNet(cfg, device="cpu")
    b.load_state_dict(a.state_dict())
    x = torch.rand(BATCH, RESIZE, 2 * RESIZE, 3,
                   generator=torch.Generator().manual_seed(1))
    fused = a.apply_packed(x, train=train)
    plain = b.apply_packed(x, train=train, fused_maps=False)
    assert (fused.seg_logits is None) == train
    if not train:
        torch.testing.assert_close(fused.seg_logits, plain.seg_logits,
                                   rtol=1e-4, atol=1e-4)
    for f in ("beta", "line_logits", "horizon_logits", "encoder_features"):
        torch.testing.assert_close(getattr(fused, f), getattr(plain, f),
                                   rtol=1e-4, atol=1e-4)
    if train:
        for out, net in ((fused, a), (plain, b)):
            (out.beta.square().sum() + out.line_logits.sum()).backward()
        gmax = max(float(p.grad.abs().max()) for p in b.parameters()
                   if p.grad is not None)
        for (k, p), q in zip(b.named_parameters(), a.parameters()):
            assert (p.grad is None) == (q.grad is None), k
            if p.grad is not None:
                torch.testing.assert_close(q.grad, p.grad, rtol=2e-3,
                                           atol=2e-3 * gmax, msg=k)
