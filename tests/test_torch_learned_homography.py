"""The learned homography end to end, and the plain-graph e2e step
(`packed_train=False`), the port against the JAX package on the CPU.

Config `train_sh_config(resize=32, batch_size=2, reg_ls=1.0,
learn_homography=True)`: `LaneNet.forward` in eval and train mode
(M, M_inv, beta, logits, new running statistics) against JAX's flax
`LaneNet.apply`, and one e2e train step of each package on the same
weights and batch, dropout off (flax's Dropout an identity for the call,
as tests/test_torch_phases.py does): the port's `make_train_step` on
`LaneNet.forward(train=True)` against JAX's `make_loss_fn` on its flax
graph (JAX's `_resolve_packed` off a TPU) with the adam update of its
`make_train_step`. The same step with `packed_train=False` and no
learned homography. Then the Trainer through `main_torch.main`: one
epoch, a checkpoint with the head, a resume, `--test_only` through
`compute_coordinates_with_M`; and the two JAX-side records of this
option (ROADMAP Queue 3), each pinned.

Weights: seeded in the port (Lecun-normal kernels, BatchNorm away from
identity, `fc_offsets` non-zero so that M moves off the fixed matrix),
carried to JAX by `variables_from_state_dict`, with every NB1D block's
bn2 scale times 0.1 as tests/test_torch_phases.py damps them: as drawn, a
train-mode step at this size does not reproduce itself (measured on
JAX's init with BatchNorm moved off identity: JAX's own whole gradient
against JAX's with one bit of one input pixel flipped, cosine 0.953; the
port against JAX 0.993). Damped, that yardstick reads 0.99997 and the
port against JAX 0.999995.

Bars, each beside its reading on these weights (M moves 2.5e-2 of
max|M| off the fixed matrix): in eval mode M and M_inv at 1e-4 of their
max (tests/test_torch_dlt.py's DLT bar; read 3.1e-6 and 1.4e-5) and the
logits at 1e-4 (read 7.4e-7); in train mode, where the head's BatchNorm
takes the statistics of 16 values a channel, M, M_inv and the logits at
1e-3 (read 5.6e-6, 6.1e-5, 6.9e-5; the train-mode parity limit of
ROADMAP Queue 3 is 4e-4); beta per coefficient column at 2e-3 of its max
(tests/test_torch_dlt.py; read up to 2.2e-4); the losses rtol 2e-3 and
the heads' losses 1e-4 (tests/test_torch_train_step.py; read 2.9e-5 and
2.1e-5); the whole gradient cosine > 0.9999 and norm ratio within 1e-3
of 1 (tests/test_torch_phases.py; read 0.99998 in both configs); every
homography_head leaf's gradient at 1e-3 of its own max|g| (read up to
3.3e-4), except the four convolution biases ahead of a train-mode
BatchNorm, whose true gradient is 0 and whose computed one is rounding
noise on both sides: held against 0 at 1e-4 of the head's max|g| (read
1.9e-7); new running statistics atol 1e-4 (read 5.3e-6); parameters
after adam where the gradient is clear of noise at 5e-2 lr.
"""

import os
import warnings

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main_torch
from lanedetection_end2end_tpu.config import train_sh_config as jax_config
from lanedetection_end2end_tpu.eval import test_driver as jax_test_driver
from lanedetection_end2end_tpu.eval.projections import (
    Projections as JaxProjections)
from lanedetection_end2end_tpu.models import LaneNet as JaxLaneNet
from lanedetection_end2end_tpu.models.infer_engine import (
    FusedLaneNetEngine as JaxEngine)
from lanedetection_end2end_tpu.models.init import (
    init_weights as jax_init_weights)
from lanedetection_end2end_tpu.train import steps as jsteps
from lanedetection_end2end_tpu.train.optim import define_optim as jax_optim
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.data.labels import read_json_lines
from lanedetection_end2end_tpu_torch.eval import test_driver
from lanedetection_end2end_tpu_torch.eval.projections import Projections
from lanedetection_end2end_tpu_torch.geometry import bev_matrices_pixel
from lanedetection_end2end_tpu_torch.models.init import init_weights
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.models.port import (
    variables_from_state_dict)
from lanedetection_end2end_tpu_torch.ops.nb_block import nb_half_a
from lanedetection_end2end_tpu_torch.train import steps as tsteps
from lanedetection_end2end_tpu_torch.train.checkpoint import _ckpt_path
from lanedetection_end2end_tpu_torch.train.optim import define_optim
from test_torch_train_step import flat, make_batch

RESIZE, BATCH, LR = 32, 2, 1e-3
KW = dict(resize=RESIZE, batch_size=BATCH, reg_ls=1.0, learning_rate=LR)
CONFIGS = {"learned": dict(learn_homography=True),
           "plain graph": dict(packed_train=False)}
PRE_BN_BIASES = {f"homography_head/conv{i}/bias" for i in range(1, 5)}


def seeded_lanenet(cfg, seed=0):
    """The port's LaneNet with Lecun-normal kernels (flax fans), small
    biases, BatchNorm away from identity, bn2 scales x 0.1 and, with the
    learned homography, a non-zero `fc_offsets`."""
    g = torch.Generator().manual_seed(seed)
    net = LaneNet(cfg, device="cpu")
    with torch.no_grad():
        for name, m in net.named_modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(0.8 + 0.4 * torch.rand(n, generator=g))
                if name.endswith("bn2"):
                    m.weight.mul_(0.1)
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                                torch.nn.Linear)):
                w = m.weight
                fan_in = (w.shape[0] * w[0, 0].numel()
                          if isinstance(m, torch.nn.ConvTranspose2d)
                          else w[0].numel())
                w.copy_(torch.randn(w.shape, generator=g) / fan_in ** 0.5)
                m.bias.copy_(0.01 * torch.randn(m.bias.shape, generator=g))
        if cfg.learn_homography:
            net.homography_head.fc_offsets.weight.mul_(4.0)
    return net


def run_case(name):
    """Eval and train forwards (learned homography only) and one train
    step of both packages; -> dict of numpy results."""
    mp = pytest.MonkeyPatch()
    mp.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        return _run_case(name)
    finally:
        mp.undo()


def _run_case(name):
    jcfg, cfg = jax_config(**KW, **CONFIGS[name]), train_sh_config(
        **KW, **CONFIGS[name])
    net = seeded_lanenet(cfg)
    sd0 = {k: v.clone() for k, v in net.state_dict().items()}
    v = variables_from_state_dict(sd0, RESIZE)
    jnet = JaxLaneNet(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    batch = make_batch(rng)
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    tbatch = {k: torch.from_numpy(a) for k, a in batch.items()}
    out = {"cfg": cfg, "old": flat(v["params"])}

    if cfg.learn_homography:
        images = jsteps.prepare_batch(jbatch)["image"]

        keys = ("M", "M_inv", "beta", "seg_logits", "line_logits",
                "horizon_logits")

        def forwards(v, images):
            ev = jnet.apply(v, images, phase="e2e", train=False)
            tr, upd = jnet.apply(v, images, phase="e2e", train=True,
                                 mutable=["batch_stats"])
            return ({k: getattr(ev, k) for k in keys},
                    {k: getattr(tr, k) for k in keys}, upd["batch_stats"])

        jev, jtr, jstats = forwards(v, images)
        timages = tsteps.prepare_batch(tbatch)["image"]
        tev = net.forward(timages, train=False)
        with torch.no_grad():
            ttr = net.forward(timages, train=True)
        out.update(jev=jev, jtr=jtr, tev=tev, ttr=ttr,
                   fwd_stats=flat(variables_from_state_dict(
                       net.state_dict(), RESIZE)["batch_stats"]),
                   jfwd_stats=flat(jax.device_get(jstats)))
        net.load_state_dict(sd0)

    loss_fn = jsteps.make_loss_fn(jnet, jcfg, "e2e", train=True)
    (_, (jmetrics, jout, jbs)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], v["batch_stats"], jbatch, None)
    tx = jax_optim("adam", LR)
    updates, _ = tx.update(jgrads, tx.init(v["params"]), v["params"])
    jparams = jax.tree_util.tree_map(lambda p, u: p + u, v["params"],
                                     updates)
    with torch.no_grad():  # the train-mode outputs, on a copy of the stats
        _, _, toutputs = tsteps.make_loss_fn(net, cfg, train=True)(tbatch)
    net.load_state_dict(sd0)
    launches = nb_half_a.launches
    opt = define_optim(net.parameters(), cfg.optimizer, cfg.learning_rate)
    step = tsteps.make_train_step(net, cfg, opt, device="cpu")
    metrics = step(tbatch, None)
    new = variables_from_state_dict(net.state_dict(), RESIZE)
    out.update(
        metrics={k: float(t) for k, t in metrics.items()},
        jmetrics={k: float(t) for k, t in jmetrics.items()},
        beta=toutputs["beta"].detach().numpy(),
        jbeta=np.asarray(jout["beta"]),
        x_cal=toutputs["x_cal"].detach().numpy(),
        jx_cal=np.asarray(jout["x_cal"]),
        grads=flat(variables_from_state_dict(
            {k: p.grad for k, p in net.named_parameters()
             if p.grad is not None}, RESIZE)["params"]),
        jgrads=flat(jax.device_get(jgrads)),
        params=flat(new["params"]), stats=flat(new["batch_stats"]),
        jparams=flat(jax.device_get(jparams)),
        jstats=flat(jax.device_get(jbs)), step=step,
        launches=nb_half_a.launches - launches)
    return out


_RUNS = {}


def get_run(name):
    if name not in _RUNS:
        _RUNS[name] = run_case(name)
    return _RUNS[name]


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    return request.param, get_run(request.param)


@pytest.fixture(scope="module")
def learned():
    return get_run("learned")


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def beta_cols(got, want):
    return [rel(got[..., i], want[..., i]) for i in range(want.shape[-1])]


# ----------------------------------------------------------------------
# LaneNet.forward with the learned homography
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode,tol", [("ev", 1e-4), ("tr", 1e-3)],
                         ids=["eval", "train"])
def test_forward_matches_jax(learned, mode, tol):
    t, j = learned["t" + mode], learned["j" + mode]
    assert t.M.shape == t.M_inv.shape == (BATCH, 3, 3)
    # the offsets moved the matrices off the fixed one
    assert rel(np.asarray(j["M"])[0], bev_matrices_pixel(RESIZE)[0]) > 1e-3
    assert max(beta_cols(t.beta.detach().numpy(),
                         np.asarray(j["beta"]))) < 2e-3
    for k in ("M", "M_inv", "seg_logits", "line_logits", "horizon_logits"):
        assert rel(getattr(t, k).detach(), j[k]) < tol, k


def test_train_forward_running_stats_match_jax(learned):
    r = learned
    assert set(r["fwd_stats"]) == set(r["jfwd_stats"])
    assert any(k.startswith("homography_head/") for k in r["fwd_stats"])
    for k, want in r["jfwd_stats"].items():
        np.testing.assert_allclose(r["fwd_stats"][k], want, atol=1e-4,
                                   err_msg=k)


# ----------------------------------------------------------------------
# One e2e train step
# ----------------------------------------------------------------------

@pytest.mark.parametrize("key,rtol", [
    ("loss", 2e-3), ("loss_line", 1e-4), ("loss_horizon", 1e-4),
    ("acc_line", 1e-6), ("acc_horizon", 1e-6)])
def test_step_metrics_match_jax(case, key, rtol):
    _, r = case
    assert sorted(r["metrics"]) == sorted(r["jmetrics"])
    np.testing.assert_allclose(r["metrics"][key], r["jmetrics"][key],
                               rtol=rtol)


def test_step_beta_and_x_cal_match_jax(case):
    _, r = case
    assert r["beta"].shape == r["jbeta"].shape == (BATCH, 4, 4)
    assert max(beta_cols(r["beta"], r["jbeta"])) < 2e-3
    assert rel(r["x_cal"], r["jx_cal"]) < 2e-3


def test_step_runs_on_the_plain_graph(case):
    """No kernel wrapper ran (the packed path is not taken), as JAX runs
    both configs on its flax graph."""
    _, r = case
    assert r["launches"] == 0 and r["step"].state.step == 1


def test_whole_gradient_matches_jax(case):
    _, r = case
    g, jg = r["grads"], r["jgrads"]
    used = [k for k in jg if np.abs(jg[k]).max() > 0]
    assert set(g) == set(used)
    a = np.concatenate([g[k].ravel() for k in used]).astype(np.float64)
    b = np.concatenate([jg[k].ravel() for k in used]).astype(np.float64)
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos > 0.9999, cos
    assert abs(np.linalg.norm(a) / np.linalg.norm(b) - 1) < 1e-3


def test_homography_head_gradients_match_jax(learned):
    g, jg = learned["grads"], learned["jgrads"]
    head = sorted(k for k in jg if k.startswith("homography_head/"))
    assert len(head) == 20 and set(head) <= set(g)
    hmax = max(np.abs(jg[k]).max() for k in head)
    for k in head:
        if k in PRE_BN_BIASES:  # true gradient 0: rounding noise
            assert np.abs(g[k]).max() < 1e-4 * hmax, k
            assert np.abs(jg[k]).max() < 1e-4 * hmax, k
        else:
            assert rel(g[k], jg[k]) < 1e-3, k
    assert np.abs(jg["homography_head/fc_offsets/kernel"]).max() > 0


def test_homography_head_after_adam_matches_jax(learned):
    """Adam's first step moves a parameter by about lr in its gradient's
    direction; compare where the reference gradient is clear of noise."""
    r = learned
    moved = 0
    for k, want in r["jparams"].items():
        if not k.startswith("homography_head/"):
            continue
        assert np.abs(r["params"][k] - r["old"][k]).max() <= 1.01 * LR, k
        if k in PRE_BN_BIASES:
            continue
        jg = r["jgrads"][k]
        clear = np.abs(jg) > 0.2 * np.abs(jg).max()
        np.testing.assert_allclose(r["params"][k][clear], want[clear],
                                   atol=0.05 * LR, err_msg=k)
        moved += int(clear.sum())
    assert moved > 100


def test_step_running_stats_match_jax(case):
    _, r = case
    assert set(r["stats"]) == set(r["jstats"])
    for k, want in r["jstats"].items():
        np.testing.assert_allclose(r["stats"][k], want, atol=1e-4,
                                   err_msg=k)


# ----------------------------------------------------------------------
# The choice of graph, and the records of ROADMAP Queue 3
# ----------------------------------------------------------------------

@pytest.mark.parametrize("extra,packed", [
    ({}, True), (dict(packed_train=True), True),
    (dict(packed_train=False), False), (dict(learn_homography=True), False),
    (dict(learn_homography=True, packed_train=True), False)])
def test_resolve_packed_follows_jax(extra, packed):
    """The port takes the packed path where JAX's `_resolve_packed` would
    on a TPU. Where a forced packed_train=True cannot be honoured, JAX
    warns and runs its flax graph; the port refuses with ValueError
    (ROADMAP Queue 3): it gives no kernel's work to the plain graph
    unasked."""
    cfg, jcfg = train_sh_config(**KW, **extra), jax_config(**KW, **extra)
    net = LaneNet(cfg, device="cpu")
    forced = extra.get("packed_train") and not packed
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        if forced:
            with pytest.raises(ValueError, match="packed_train=True"):
                tsteps.resolve_packed(net, cfg, "e2e")
            with pytest.raises(ValueError, match="packed_train=True"):
                tsteps.make_loss_fn(net, cfg, "e2e")
        else:
            assert tsteps.resolve_packed(net, cfg, "e2e") is packed
        for phase in ("skip", "seg"):  # no packed path, whatever the flag
            assert tsteps.resolve_packed(net, cfg, phase) is False
        assert net.packed_supported("e2e") is (
            not cfg.learn_homography)
        jnet = JaxLaneNet(jcfg)
        assert jnet.packed_supported("e2e") is net.packed_supported("e2e")
        if "packed_train" in extra:
            assert jsteps._resolve_packed(jnet, jcfg, "e2e") is packed
    warned = [w for w in seen if issubclass(w.category, RuntimeWarning)]
    assert len(warned) == (1 if forced else 0)  # JAX's, not the port's
    if not net.packed_supported("e2e"):
        with pytest.raises(ValueError, match="packed path"):
            net.apply_packed(torch.zeros(1, RESIZE, 2 * RESIZE, 3))


def test_init_weights_redraws_fc_offsets_in_both_packages():
    """ROADMAP Queue 3, JAX side, recorded (a): the Trainer's
    `init_weights` re-draws every kernel, `fc_offsets` included, so a
    Trainer run does not start from the calibrated homography that
    `models/dlt.py` promises. The port follows JAX."""
    tree = {"params": {"homography_head": {
        "fc_offsets": {"kernel": jnp.zeros((128, 3)),
                       "bias": jnp.zeros(3)},
        "conv1_bn": {"scale": jnp.ones(128), "bias": jnp.zeros(128)}}},
        "batch_stats": {}}
    j = jax_init_weights(tree, "xavier", jax.random.PRNGKey(0))["params"][
        "homography_head"]
    assert np.abs(np.asarray(j["fc_offsets"]["kernel"])).max() > 0
    assert not np.asarray(j["fc_offsets"]["bias"]).any()
    net = LaneNet(train_sh_config(**KW, learn_homography=True),
                  device="cpu")
    head = net.homography_head
    assert not head.fc_offsets.weight.any()  # fresh: the calibrated matrix
    init_weights(net, "xavier", torch.Generator().manual_seed(0))
    assert head.fc_offsets.weight.abs().max() > 0
    for name, m in head.named_children():
        assert not m.bias.any(), name
        if name.endswith("_bn"):
            assert (m.weight - 1).abs().max() < 0.2 and m.weight.std() > 0


def test_test_model_refuses_the_engine_with_the_learned_homography(
        monkeypatch):
    """ROADMAP Queue 3, JAX side, recorded (b): JAX's `test_model(
    use_engine=True)` serves through `FusedLaneNetEngine`, whose fitter is
    the fixed matrix's (no homography head, no per-sample fit), and its
    infer function projects without M. The port refuses the pair."""
    jcfg = jax_config(**KW, learn_homography=True)
    engine = JaxEngine(jcfg)
    fixed = JaxLaneNet(jax_config(**KW)).fitter
    np.testing.assert_array_equal(np.asarray(engine.fitter._sep_coeff),
                                  np.asarray(fixed._sep_coeff))

    def engine_call(packed, variables, images):
        B = images.shape[0]
        return (jnp.ones((B, 4, 4)), jnp.zeros((B, 4)),
                jnp.zeros((B, RESIZE)))

    def refuse(*a, **k):
        raise AssertionError("the engine path projected with M")

    monkeypatch.setattr(JaxProjections, "compute_coordinates_with_M",
                        refuse)
    infer = jax_test_driver.make_infer_fn(
        JaxLaneNet(jcfg), jcfg, JaxProjections(RESIZE, 3), engine_call, {})
    assert infer({}, jnp.zeros((2, RESIZE, 2 * RESIZE, 3))).shape == (
        2, 4, 56)
    cfg = train_sh_config(**KW, learn_homography=True)
    with pytest.raises(ValueError, match="homography head"):
        test_driver.test_model(None, LaneNet(cfg, device="cpu"), cfg,
                               save_path="unused", use_engine=True)


# ----------------------------------------------------------------------
# The Trainer through main_torch.py
# ----------------------------------------------------------------------

def _argv(save_path, *extra):
    return ("--synthetic 10 --resize 32 --batch_size 4 --val_batch_size 2 "
            "--loss_policy backproject --nclasses 4 --order 3 --clas 1 "
            "--mask_percentage 0.20 --flip_on 1 --reg_ls 1.0 "
            "--print_freq 1000 --save_freq 100 --nworkers 2 "
            "--learn_homography true "
            f"--save_path {save_path} --no_cuda true").split() + list(extra)


def test_trainer_checkpoints_resumes_and_tests_with_the_head(tmp_path,
                                                             monkeypatch):
    import sys
    from lanedetection_end2end_tpu_torch.train import driver
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # the Logger tee
    last = main_torch.main(_argv(tmp_path, "--nepochs", "1"))
    assert np.isfinite(last["train_loss"]) and np.isfinite(last["val_loss"])
    cfg = main_torch.parse_args(_argv(tmp_path))[0]
    assert cfg.learn_homography
    run_dir = os.path.join(str(tmp_path), cfg.save_id)
    sd = torch.load(_ckpt_path(run_dir, 0), map_location="cpu",
                    weights_only=False)["state_dict"]["model"]
    head = {k for k in sd if k.startswith("homography_head.")}
    assert "homography_head.fc_offsets.weight" in head and len(head) == 32

    resumed = {}
    resume = driver.Trainer.maybe_resume

    def watched(self):
        ok = resume(self)
        resumed.update(start=self.start_epoch, equal=all(
            torch.equal(t, sd[k]) for k, t in
            self.lanenet.state_dict().items()))
        return ok

    monkeypatch.setattr(driver.Trainer, "maybe_resume", watched)
    main_torch.main(_argv(tmp_path, "--nepochs", "2"))
    assert resumed == {"start": 1, "equal": True}
    rows = read_json_lines(os.path.join(run_dir, "scalars.jsonl"))
    assert [r["epoch"] for r in rows] == [1, 2]

    calls = []
    with_M = Projections.compute_coordinates_with_M

    def counted(self, *a):
        calls.append(a[0].shape)
        return with_M(self, *a)

    monkeypatch.setattr(Projections, "compute_coordinates_with_M", counted)
    out = main_torch.main(_argv(tmp_path, "--nepochs", "2", "--test_only"))
    assert 0.0 <= out["acc"] <= 1.0 and calls
