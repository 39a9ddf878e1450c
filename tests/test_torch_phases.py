"""The staged schedule's skip and seg steps, the port against the JAX
package on the CPU, in both profiles: one train step (and the eval step)
on the same weights and batch, the port's `make_train_step(phase)` on
`LaneNet.forward(train=True)` against JAX's flax step
(`make_loss_fn(..., use_packed=False)`, as JAX trains these phases).

Configs at resize 32, batch 2, with the pretraining head: the train.sh
config with `pretrained=True` (BP, 4 lanes, the heads), the BEV 2-lane
default with `pretrained=True`, and the BP 2-lane config with
`end_to_end=False` (the background channel on the main head). Dropout
off (flax's Dropout an identity on the JAX side for the call).

The weights are JAX's init with BatchNorm moved off identity and every
NB1D block's bn2 scale times 0.1, as chip_smoke damps them for its
whole-gradient bars: as drawn, a train-mode cross-entropy gradient at
this size does not reproduce itself (measured: JAX's own gradient
against JAX's with one bit of one input pixel flipped, cosine 0.884 in
the BP skip step and 0.936 in the BEV seg step; the port against JAX
0.989 in the BP skip step and 0.991 in the BEV one). Damped, that yardstick reads 0.99989 to 0.99998 and the port
against JAX 0.99997 to 0.999998. Bars: whole gradient cosine > 0.9999 and
norm ratio within 1e-3 of 1, every leaf at 5e-2 of max|g|; loss and
metrics rtol 2e-3 (tests/test_torch_train_step.py); new running
statistics atol 1e-4. The seg phase's argmax maps are held exactly in
tests/test_torch_bev.py. A seg step needs the background channel:
without one both packages raise."""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.config import bev_defaults as jax_bev
from lanedetection_end2end_tpu.config import bp_defaults as jax_bp
from lanedetection_end2end_tpu.config import train_sh_config as jax_sh
from lanedetection_end2end_tpu.models import LaneNet as JaxLaneNet
from lanedetection_end2end_tpu.train import steps as jsteps
from lanedetection_end2end_tpu_torch.config import (
    bev_defaults, bp_defaults, train_sh_config)
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.models.port import (
    state_dict_from_variables, variables_from_state_dict)
from lanedetection_end2end_tpu_torch.train import steps as tsteps
from lanedetection_end2end_tpu_torch.train.optim import define_optim
from test_torch_train_step import flat, make_batch, randomize_bn

RESIZE, BATCH, LR = 32, 2, 1e-3
CONFIGS = {
    "bp-pretrained": (train_sh_config, jax_sh, dict(pretrained=True)),
    "bev-pretrained": (bev_defaults, jax_bev, dict(pretrained=True)),
    "bp-seg-only": (bp_defaults, jax_bp, dict(end_to_end=False)),
}
CASES = [("bp-pretrained", "skip"), ("bp-pretrained", "seg"),
         ("bev-pretrained", "skip"), ("bev-pretrained", "seg"),
         ("bp-seg-only", "seg")]


def _batch(rng, cfg):
    batch = make_batch(rng)
    batch["gt"] = rng.integers(0, cfg.nclasses + 1,
                               (BATCH, RESIZE, 2 * RESIZE)).astype(np.uint8)
    if cfg.profile == "bev":
        params = np.stack([rng.normal(0, 0.05, (BATCH, 4)),
                           rng.normal(0, 0.1, (BATCH, 4)),
                           rng.uniform(0.3, 0.7, (BATCH, 4))], -1)
        batch["params"] = params.astype(np.float32)
    return batch


def damp_bn2(v):
    """Every NB1D block's bn2 scale times 0.1 (numpy leaves, in place)."""
    def walk(p):
        for k, x in p.items():
            if k == "bn2":
                x["scale"] = x["scale"] * 0.1
            elif isinstance(x, dict):
                walk(x)
    walk(v["params"])
    return v


def run_phase(name, phase):
    """One step of `phase` in both packages; JAX's flax Dropout is an
    identity for the call (the port's steps run without a generator), as
    the packed JAX step runs with rng=None."""
    mp = pytest.MonkeyPatch()
    mp.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        return _run_phase(name, phase)
    finally:
        mp.undo()


def _run_phase(name, phase):
    port_cfg, jax_cfg, extra = CONFIGS[name]
    kw = dict(resize=RESIZE, batch_size=BATCH, reg_ls=1.0, learning_rate=LR,
              **extra)
    jcfg, cfg = jax_cfg(**kw), port_cfg(**kw)
    rng = np.random.default_rng(len(name) + len(phase))
    jnet = JaxLaneNet(jcfg, dtype=jnp.float32)
    v = damp_bn2(randomize_bn(jnet.init(jax.random.PRNGKey(1)), rng))
    batch = _batch(rng, cfg)
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    loss_fn = jsteps.make_loss_fn(jnet, jcfg, phase, train=True,
                                  use_packed=False)
    (_, (jmetrics, _, jbs)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], v["batch_stats"], jbatch, None)
    jeval = jax.jit(jsteps.make_loss_fn(jnet, jcfg, phase, train=False,
                                        use_packed=False))(
        v["params"], v["batch_stats"], jbatch, None)[1]

    net = LaneNet(cfg, device="cpu")
    sd = state_dict_from_variables(v, profile=cfg.profile)
    net.load_state_dict(sd)
    tbatch = {k: torch.from_numpy(a) for k, a in batch.items()}
    teval = tsteps.make_eval_step(net, cfg, phase, device="cpu")(tbatch)
    opt = define_optim(net.parameters(), "adam", LR)
    metrics = tsteps.make_train_step(net, cfg, opt, phase,
                                     device="cpu")(tbatch)
    grads = variables_from_state_dict(
        {k: p.grad for k, p in net.named_parameters()
         if p.grad is not None}, RESIZE)["params"]
    new = variables_from_state_dict(net.state_dict(), RESIZE)
    return {"metrics": {k: float(t) for k, t in metrics.items()},
            "jmetrics": {k: float(t) for k, t in jmetrics.items()},
            "grads": flat(grads), "jgrads": flat(jgrads),
            "stats": flat(new["batch_stats"]),
            "jstats": flat(jax.device_get(jbs)),
            "eval": teval, "jeval": jeval, "cfg": cfg,
            "moved": {k for k, p in net.state_dict().items()
                      if not torch.equal(p, sd[k])}}


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{n}-{p}" for n, p in CASES])
def case(request):
    return request.param, run_phase(*request.param)


def test_step_metrics_match_jax(case):
    (_, phase), r = case
    got, want = r["metrics"], r["jmetrics"]
    assert sorted(got) == sorted(want)
    if phase == "seg":
        assert ("area_sq" if r["cfg"].profile == "bev" else "rmse") in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, err_msg=k)


def test_step_gradient_matches_jax(case):
    _, r = case
    g, jg = r["grads"], r["jgrads"]
    used = [k for k in jg if np.abs(jg[k]).max() > 0]
    assert set(g) == set(used)
    # only the backbone and the head the phase reads receive gradients
    assert not any(k.startswith(("line_", "horizon_")) for k in g)
    dot = sum(float((g[k] * jg[k]).sum()) for k in used)
    n1 = np.sqrt(sum(float((g[k] ** 2).sum()) for k in used))
    n2 = np.sqrt(sum(float((jg[k] ** 2).sum()) for k in used))
    assert dot / (n1 * n2) > 0.9999, dot / (n1 * n2)
    assert abs(n1 / n2 - 1) < 1e-3, n1 / n2
    gmax = max(float(np.abs(a).max()) for a in jg.values())
    for k in g:
        np.testing.assert_allclose(g[k], jg[k], atol=5e-2 * gmax, rtol=5e-2,
                                   err_msg=k)


def test_step_running_stats_match_jax(case):
    """Every BatchNorm's new statistics, the heads' too: JAX runs them in
    train mode in every phase."""
    _, r = case
    assert set(r["stats"]) == set(r["jstats"])
    for k, want in r["jstats"].items():
        np.testing.assert_allclose(r["stats"][k], want, atol=1e-4, err_msg=k)


def test_eval_step_matches_jax(case):
    (_, phase), r = case
    (metrics, outputs), (jmetrics, jout, _) = r["eval"], r["jeval"]
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=2e-3, err_msg=k)
    assert sorted(outputs) == sorted(jout)
    if phase == "seg":
        want = np.asarray(jout["beta"])
        np.testing.assert_allclose(outputs["beta"].numpy(), want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max())


def test_unreached_parameters_stay_as_in_jax(case):
    """A parameter no loss reaches takes a zero gradient, as in JAX: adam
    leaves it where it was on the first step (and `.grad` stays None)."""
    (name, phase), r = case
    cfg = r["cfg"]
    head = ("net.decoder.output_conv." if cfg.pretrained
            else "net.encoder.output_conv.")
    assert not any(k.startswith(head) for k in r["moved"])
    assert not any(k.startswith(("line_", "horizon_"))
                   and "running" not in k and "num_batches" not in k
                   for k in r["moved"])


@pytest.mark.parametrize("phase", ["skip", "seg"])
def test_seg_phases_need_the_background_channel(phase):
    """Without the pretraining head or end_to_end off, the logits have no
    background channel: both packages refuse a skip or seg step."""
    kw = dict(resize=RESIZE, batch_size=BATCH)
    jnet = JaxLaneNet(jax_bp(**kw))
    v = jnet.init(jax.random.PRNGKey(0))
    batch = _batch(np.random.default_rng(0), bp_defaults(**kw))
    with pytest.raises(ValueError, match="background channel"):
        jsteps.make_loss_fn(jnet, jax_bp(**kw), phase, train=False,
                            use_packed=False)(
            v["params"], v["batch_stats"],
            {k: jnp.asarray(a) for k, a in batch.items()}, None)
    with pytest.raises(ValueError, match="background channel"):
        tsteps.make_loss_fn(LaneNet(bp_defaults(**kw), device="cpu"),
                            bp_defaults(**kw), phase)
