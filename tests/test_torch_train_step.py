"""The slice as a whole: one e2e train step of the port against the JAX
package's on the CPU.

Config `train_sh_config(resize=32, batch_size=2, reg_ls=1.0)`, the same
weights (through `state_dict_from_variables`), the same compact batch
(uint8 images with a per-sample flip), dropout off (`rng=None` / no
generator: the packages' random streams cannot match). The JAX side runs
`packed_train=True` with PACKED_PALLAS=1, PACKED_FUSED_BLOCKS=1,
PACKED_FUSED_MAPS=0 (Pallas kernels in interpret mode); the port runs its
plain versions through `make_train_step(..., device="cpu",
fused_maps=False)` (`run_both` with its default). The default
configuration, fused maps on, is held in
tests/test_torch_train_step_fused.py.

Bars, float32. In eval mode the two packages' logits agree to 2e-7, but a
train-mode step does not reach that: every BatchNorm takes its variance as
sum(y^2)/n - mean^2 in f32, whose rounding depends on the summation order,
over as few as 64 values per channel at this size, and 23 normalized
stages and an ill-conditioned cubic fit on random weight maps amplify it
(measured: logits 4e-4, beta 8e-4, loss 3.8e-4 relative). So:
the head losses rtol 1e-4; the total loss and beta rtol 2e-3 (the JAX
package's own rtol for its fused forward, tests/test_fused_blocks.py:143);
the whole gradient by cosine > 0.999 and norm ratio in 0.98-1.02
(tests/test_fused_blocks.py:348-358); leaf by leaf at 2e-3 * max|g| for
the leaves with no relu or maxpool between them and the loss, and at
5e-2 * max|g| for every other leaf (measured worst 2.5e-2, in the first
convolution); new running statistics atol 1e-4; parameters after one adam
step where the gradient is clear of rounding noise.

In bf16 the two packages round in other places (the port's elementwise
BatchNorm rounds after the multiply and after the add) and the same
amplification applies: beta at the serving engine's bar for bf16,
max|diff| / max|ref| < 3e-2 (tests/test_torch_engine.py; measured 2.2e-2),
and the losses, whose pixel MSE squares that error, at rtol 6e-2
(measured 3.6e-2 total, 4.3e-2 for the line head's bf16 mean of 8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.config import train_sh_config as jax_config
from lanedetection_end2end_tpu.models import LaneNet as JaxLaneNet
from lanedetection_end2end_tpu.train.optim import define_optim as jax_optim
from lanedetection_end2end_tpu.train import steps as jsteps
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.models.port import (
    state_dict_from_variables, variables_from_state_dict)
from lanedetection_end2end_tpu_torch.ops.nb_block import nb_half_a, nb_half_b
from lanedetection_end2end_tpu_torch.ops.packed_conv import channel_sums
from lanedetection_end2end_tpu_torch.train import steps as tsteps
from lanedetection_end2end_tpu_torch.train.optim import define_optim, get_lr

RESIZE, BATCH, LR = 32, 2, 1e-3


def randomize_bn(variables, rng):
    """BatchNorm scale/bias and running statistics away from identity."""
    def walk(p, s):
        for k in p:
            if "mean" in s.get(k, {}):
                n = s[k]["mean"].shape[0]
                p[k] = {"scale": rng.uniform(0.8, 1.2, n).astype(np.float32),
                        "bias": rng.normal(0, 0.1, n).astype(np.float32)}
                s[k] = {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    walk(v["params"], v["batch_stats"])
    return v


def make_batch(rng):
    return {
        "image": rng.integers(0, 256, (BATCH, RESIZE, 2 * RESIZE, 3),
                              dtype=np.uint8),
        "flip": np.array([True, False]),
        "lanes": rng.uniform(0, 2 * RESIZE, (BATCH, 4, 56)).astype(
            np.float32),
        "valid_points": (rng.uniform(size=(BATCH, 4, 56)) > 0.3).astype(
            np.float32),
        "line": (rng.uniform(size=(BATCH, 4)) > 0.5).astype(np.float32),
        "horizon": (rng.uniform(size=(BATCH, RESIZE)) > 0.9).astype(
            np.float32)}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def run_both(dtype_name, with_grads=True, fused_maps=False,
             fused_blocks=True):
    """One train step (and an eval step) of both packages on the same
    weights and batch; `fused_maps` and `fused_blocks` set
    PACKED_FUSED_MAPS and PACKED_FUSED_BLOCKS on the JAX side and the
    port's arguments of the same names."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PACKED_PALLAS", "1")
    mp.setenv("PACKED_FUSED_BLOCKS", "1" if fused_blocks else "0")
    mp.setenv("PACKED_FUSED_MAPS", "1" if fused_maps else "0")
    mp.delenv("PACKED_BANDED", raising=False)
    try:
        rng = np.random.default_rng(0)
        jdtype = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
        jcfg = jax_config(resize=RESIZE, batch_size=BATCH, reg_ls=1.0,
                          packed_train=True, learning_rate=LR,
                          compute_dtype=dtype_name)
        jnet = JaxLaneNet(jcfg, dtype=jdtype)
        v = randomize_bn(jnet.init(jax.random.PRNGKey(0)), rng)
        batch = make_batch(rng)
        jbatch = {k: jnp.asarray(a) for k, a in batch.items()}

        loss_fn = jsteps.make_loss_fn(jnet, jcfg, "e2e", train=True)
        if with_grads:
            (_, (jmetrics, jout, jbs)), jgrads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(v["params"], v["batch_stats"],
                                        jbatch, None)
            # the update of make_train_step (train/steps.py:343-345)
            tx = jax_optim("adam", LR)
            updates, _ = tx.update(jgrads, tx.init(v["params"]), v["params"])
            jparams = jax.tree_util.tree_map(lambda p, u: p + u, v["params"],
                                             updates)
        else:
            _, (jmetrics, jout, jbs) = jax.jit(loss_fn)(
                v["params"], v["batch_stats"], jbatch, None)
            jgrads, jparams = {}, {}

        cfg = train_sh_config(resize=RESIZE, batch_size=BATCH, reg_ls=1.0,
                              learning_rate=LR, compute_dtype=dtype_name)
        net = LaneNet(cfg, device="cpu")
        net.load_state_dict(state_dict_from_variables(v))
        opt = define_optim(net.parameters(), cfg.optimizer,
                           cfg.learning_rate)
        counts = [nb_half_a.launches, nb_half_b.launches,
                  channel_sums.launches]
        paths = dict(fused_blocks=fused_blocks, fused_maps=fused_maps)
        step = tsteps.make_train_step(net, cfg, opt, device="cpu", **paths)
        tbatch = {k: torch.from_numpy(a) for k, a in batch.items()}
        _, tout = tsteps.make_eval_step(net, cfg, device="cpu",
                                        **paths)(tbatch)
        with torch.no_grad():  # the train-mode beta, on a copy of the stats
            beta = tsteps.make_loss_fn(net, cfg, train=True, **paths)(
                tbatch)[2]["beta"].float().numpy()
        net.load_state_dict(state_dict_from_variables(v))
        metrics = step(tbatch, None)
        grads = variables_from_state_dict(
            {k: p.grad for k, p in net.named_parameters()
             if p.grad is not None}, RESIZE)["params"]
        new = variables_from_state_dict(net.state_dict(), RESIZE)
        return {
            "metrics": {k: float(t) for k, t in metrics.items()},
            "jmetrics": {k: float(t) for k, t in jmetrics.items()},
            "grads": flat(grads), "jgrads": flat(jgrads),
            "params": flat(new["params"]), "old": flat(v["params"]),
            "jparams": flat(jax.device_get(jparams)),
            "stats": flat(new["batch_stats"]),
            "jstats": flat(jax.device_get(jbs)),
            "beta": beta, "jbeta": np.asarray(jout["beta"], np.float32),
            "step": step, "counts": counts, "eval_out": tout}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def f32():
    return run_both("float32")


@pytest.fixture(scope="module")
def bf16():
    return run_both("bfloat16", with_grads=False)


@pytest.mark.parametrize("key,rtol", [
    ("loss", 2e-3), ("loss_line", 1e-4), ("loss_horizon", 1e-4),
    ("acc_line", 1e-6), ("acc_horizon", 1e-6)])
def test_step_metrics_match_jax(f32, key, rtol):
    np.testing.assert_allclose(f32["metrics"][key], f32["jmetrics"][key],
                               rtol=rtol)


def test_train_mode_beta_matches_jax(f32):
    got, want = f32["beta"], f32["jbeta"]
    assert got.shape == want.shape == (BATCH, 4, 4)
    # per coefficient: the columns span four orders of magnitude
    bound = 2e-3 * (np.abs(want) + np.abs(want).max(axis=(0, 1)))
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max((0, 1))


def test_whole_gradient_matches_jax(f32):
    g, jg = f32["grads"], f32["jgrads"]
    # the encoder's 1x1 predict head takes no part in the e2e loss
    used = [k for k in jg if np.abs(jg[k]).max() > 0]
    assert set(g) == set(used)
    dot = sum(float((g[k] * jg[k]).sum()) for k in used)
    n1 = np.sqrt(sum(float((g[k] ** 2).sum()) for k in used))
    n2 = np.sqrt(sum(float((jg[k] ** 2).sum()) for k in used))
    assert dot / (n1 * n2) > 0.999, dot / (n1 * n2)
    assert 0.98 < n1 / n2 < 1.02, n1 / n2


NEAR_LOSS = ("erfnet/decoder/output_conv/", "line_classification/fc_line1/",
             "horizon_estimation/fc_horizon/")


def test_gradient_leaves_match_jax(f32):
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


def test_new_running_stats_match_jax(f32):
    assert set(f32["stats"]) == set(f32["jstats"])
    for k, want in f32["jstats"].items():
        np.testing.assert_allclose(f32["stats"][k], want, atol=1e-4,
                                   err_msg=k)


def test_parameters_after_adam_step_match_jax(f32):
    """Adam's first step moves a parameter by lr * g / (|g| + eps): by
    about lr in the gradient's direction, or by noise where the gradient
    is noise. Compare where the reference gradient is clear of that."""
    moved = 0
    gmax = max(float(np.abs(v).max()) for v in f32["jgrads"].values())
    for k, want in f32["jparams"].items():
        if k not in f32["grads"]:
            np.testing.assert_array_equal(f32["params"][k], f32["old"][k])
            continue
        jg = f32["jgrads"][k]
        clear = np.abs(jg) > max(0.2 * np.abs(jg).max(), 1e-5 * gmax)
        np.testing.assert_allclose(f32["params"][k][clear], want[clear],
                                   atol=0.05 * LR, err_msg=k)
        moved += int(clear.sum())
        assert np.abs(f32["params"][k] - f32["old"][k]).max() <= 1.01 * LR
    assert moved > 300


def test_step_state_and_no_kernel_launch_on_cpu(f32):
    state = f32["step"].state
    assert state.step == 1 and get_lr(state.optimizer) == LR
    assert [nb_half_a.launches, nb_half_b.launches,
            channel_sums.launches] == f32["counts"]


def test_eval_step_outputs(f32):
    out = f32["eval_out"]
    assert out["beta"].shape == (BATCH, 4, 4)
    assert out["x_cal"].shape == (BATCH, 4, 56)
    assert out["line_pred"].shape == (BATCH, 4)
    assert out["horizon_pred"].shape == (BATCH, RESIZE)
    assert all(torch.isfinite(t.float()).all() for t in out.values())


@pytest.mark.parametrize("key", ["loss", "loss_line", "loss_horizon"])
def test_bf16_step_matches_jax(bf16, key):
    np.testing.assert_allclose(bf16["metrics"][key], bf16["jmetrics"][key],
                               rtol=6e-2)


def test_bf16_beta_matches_jax(bf16):
    got, want = bf16["beta"], bf16["jbeta"]
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() / np.abs(want).max() < 3e-2


def test_bf16_step_gradients_finite_and_parameters_move(bf16):
    assert all(np.isfinite(g).all() for g in bf16["grads"].values())
    moved = [k for k in bf16["grads"]
             if np.abs(bf16["params"][k] - bf16["old"][k]).max() > 0]
    assert len(moved) > 200


def test_prepare_batch_matches_jax():
    rng = np.random.default_rng(1)
    batch = make_batch(rng)
    batch["gt"] = rng.integers(0, 5, (BATCH, RESIZE, 2 * RESIZE),
                               dtype=np.uint8)
    want = jsteps.prepare_batch({k: jnp.asarray(a) for k, a in batch.items()})
    got = tsteps.prepare_batch({k: torch.from_numpy(a)
                                for k, a in batch.items()})
    assert set(got) == set(want) and "flip" not in got
    assert got["image"].dtype == torch.float32
    assert got["gt"].dtype == torch.int64
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
    plain = {"image": torch.rand(1, 4, 8, 3)}
    assert tsteps.prepare_batch(plain)["image"] is plain["image"]


def test_train_step_refuses_other_phases_and_profiles():
    """Both profiles and the three phases are ported; what is refused is a
    seg step without the background channel (as in JAX) and an unknown
    phase."""
    cfg = train_sh_config(resize=RESIZE)
    net = LaneNet(cfg, device="cpu")
    with pytest.raises(ValueError, match="background channel"):
        tsteps.make_loss_fn(net, cfg, phase="seg")
    with pytest.raises(ValueError, match="unknown phase"):
        tsteps.make_loss_fn(net, cfg, phase="pretrain")

