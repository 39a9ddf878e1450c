"""The BEV profile's e2e train step, the port against the JAX package on
the CPU, at 2 lanes here and 4 in tests/test_torch_bev_step4.py (the
tests imported from here), with the area loss and with the parameter
MSE.

`bev_defaults(resize=32, batch_size=2, reg_ls=1.0)` (normalized
homography, order 2), the same weights (JAX's init with BatchNorm moved
off identity, carried by `state_dict_from_variables(profile="bev")`), the
same compact batch (uint8 images, one of them flipped; curve parameters
with an absent outer lane, so the MSE's lane mask acts), dropout off. The
JAX side runs `packed_train=True` with PACKED_PALLAS=1,
PACKED_FUSED_BLOCKS=1, PACKED_FUSED_MAPS=1 (its default kernels in
interpret mode), the port `make_train_step(..., device="cpu")` on its
default path (the kernels' plain versions). The 4-lane cases carry the
BEV heads (four 3-way line classifiers and the horizon).

Bars, those of tests/test_torch_train_step.py for a float32 step and
their reasons: every metric rtol 2e-3 (the area loss is 1e-3 to 1e-5 in
size, so only a relative bar means anything; the heads' losses rtol
1e-4), the train-mode beta per coefficient at 2e-3 of its column's
largest value, the whole gradient by cosine > 0.999 and norm ratio
0.98-1.02, every leaf at 5e-2 of max|g|, new running statistics atol
1e-4; the eval step's beta at 2e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.config import bev_defaults as jax_bev
from lanedetection_end2end_tpu.models import LaneNet as JaxLaneNet
from lanedetection_end2end_tpu.train import steps as jsteps
from lanedetection_end2end_tpu_torch.config import bev_defaults
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.models.port import (
    state_dict_from_variables, variables_from_state_dict)
from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
from lanedetection_end2end_tpu_torch.train import steps as tsteps
from lanedetection_end2end_tpu_torch.train.optim import define_optim
from test_torch_train_step import flat, randomize_bn
from test_torch_threads import one_torch_thread  # noqa: F401

RESIZE, BATCH, LR = 32, 2, 1e-3
CASES = [(2, "area"), (2, "mse")]  # 4 lanes: tests/test_torch_bev_step4.py


def bev_batch(rng):
    params = np.stack([rng.normal(0, 0.05, (BATCH, 4)),
                       rng.normal(0, 0.1, (BATCH, 4)),
                       np.array([0.45, 0.55, 0.35, 0.65])
                       + rng.normal(0, 0.02, (BATCH, 4))], -1)
    params[0, 3] = 0.0  # an absent outer lane
    return {
        "image": rng.integers(0, 256, (BATCH, RESIZE, 2 * RESIZE, 3),
                              dtype=np.uint8),
        "flip": np.array([True, False]),
        "params": params.astype(np.float32),
        "line": rng.integers(0, 3, (BATCH, 4)).astype(np.int32),
        "horizon": (rng.uniform(size=(BATCH, RESIZE)) > 0.9).astype(
            np.float32)}


def run_bev(nclasses, policy):
    mp = pytest.MonkeyPatch()
    for k, v in (("PACKED_PALLAS", "1"), ("PACKED_FUSED_BLOCKS", "1"),
                 ("PACKED_FUSED_MAPS", "1")):
        mp.setenv(k, v)
    mp.delenv("PACKED_BANDED", raising=False)
    try:
        rng = np.random.default_rng(nclasses)
        kw = dict(resize=RESIZE, batch_size=BATCH, reg_ls=1.0,
                  nclasses=nclasses, clas=nclasses == 4, loss_policy=policy,
                  learning_rate=LR)
        jcfg = jax_bev(packed_train=True, **kw)
        jnet = JaxLaneNet(jcfg, dtype=jnp.float32)
        v = randomize_bn(jnet.init(jax.random.PRNGKey(nclasses)), rng)
        batch = bev_batch(rng)
        jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
        loss_fn = jsteps.make_loss_fn(jnet, jcfg, "e2e", train=True)
        (_, (jmetrics, jout, jbs)), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"], v["batch_stats"], jbatch,
                                    None)
        jeval = jax.jit(jsteps.make_loss_fn(jnet, jcfg, "e2e", train=False))(
            v["params"], v["batch_stats"], jbatch, None)[1]

        cfg = bev_defaults(**kw)
        net = LaneNet(cfg, device="cpu")
        net.load_state_dict(state_dict_from_variables(v, profile="bev"))
        tbatch = {k: torch.from_numpy(a) for k, a in batch.items()}
        teval = tsteps.make_eval_step(net, cfg, device="cpu")(tbatch)
        with torch.no_grad():
            beta = tsteps.make_loss_fn(net, cfg, train=True)(
                tbatch)[2]["beta"].numpy()
        net.load_state_dict(state_dict_from_variables(v, profile="bev"))
        counts = (lm.lane_maps_op.launches, lm.head_rowsums_op.launches)
        opt = define_optim(net.parameters(), "adam", LR)
        metrics = tsteps.make_train_step(net, cfg, opt, device="cpu")(tbatch)
        grads = variables_from_state_dict(
            {k: p.grad for k, p in net.named_parameters()
             if p.grad is not None}, RESIZE)["params"]
        new = variables_from_state_dict(net.state_dict(), RESIZE)
        return {
            "metrics": {k: float(t) for k, t in metrics.items()},
            "jmetrics": {k: float(t) for k, t in jmetrics.items()},
            "grads": flat(grads), "jgrads": flat(jgrads),
            "stats": flat(new["batch_stats"]),
            "jstats": flat(jax.device_get(jbs)),
            "beta": beta, "jbeta": np.asarray(jout["beta"]),
            "eval": teval, "jeval": jeval, "counts": counts}
    finally:
        mp.undo()


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{n}lanes-{p}" for n, p in CASES])
def case(request):
    return request.param, run_bev(*request.param)


def test_metrics_match_jax(case):
    (nclasses, _), r = case
    got, want = r["metrics"], r["jmetrics"]
    assert sorted(got) == sorted(want)
    assert "exact_area" in got
    for k in want:
        rtol = 1e-4 if k in ("loss_line", "loss_horizon") else 2e-3
        if k.startswith("acc"):
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       err_msg=k)


def test_train_mode_beta_matches_jax(case):
    (nclasses, _), r = case
    got, want = r["beta"], r["jbeta"]
    assert got.shape == want.shape == (BATCH, nclasses, 3)
    bound = 2e-3 * (np.abs(want) + np.abs(want).max(axis=(0, 1)))
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max((0, 1))


def test_whole_gradient_matches_jax(case):
    _, r = case
    g, jg = r["grads"], r["jgrads"]
    used = [k for k in jg if np.abs(jg[k]).max() > 0]
    assert set(g) == set(used)
    dot = sum(float((g[k] * jg[k]).sum()) for k in used)
    n1 = np.sqrt(sum(float((g[k] ** 2).sum()) for k in used))
    n2 = np.sqrt(sum(float((jg[k] ** 2).sum()) for k in used))
    assert dot / (n1 * n2) > 0.999, dot / (n1 * n2)
    assert 0.98 < n1 / n2 < 1.02, n1 / n2
    gmax = max(float(np.abs(a).max()) for a in jg.values())
    for k in g:
        np.testing.assert_allclose(g[k], jg[k], atol=5e-2 * gmax, rtol=5e-2,
                                   err_msg=k)


def test_new_running_stats_match_jax(case):
    _, r = case
    assert set(r["stats"]) == set(r["jstats"])
    for k, want in r["jstats"].items():
        np.testing.assert_allclose(r["stats"][k], want, atol=1e-4, err_msg=k)


def test_eval_step_matches_jax(case):
    (nclasses, _), r = case
    (metrics, outputs), (jmetrics, jout, _) = r["eval"], r["jeval"]
    want = np.asarray(jout["beta"])
    got = outputs["beta"].numpy()
    assert got.shape == want.shape == (BATCH, nclasses, 3)
    np.testing.assert_allclose(got, want, rtol=2e-3,
                               atol=2e-3 * np.abs(want).max())
    np.testing.assert_allclose(float(metrics["exact_area"]),
                               float(jmetrics["exact_area"]), rtol=2e-3)
    if nclasses == 4:  # the BEV line head: (B, 4) argmax class indices
        np.testing.assert_array_equal(outputs["line_pred"].numpy(),
                                      np.asarray(jout["line_pred"]))
    # CPU tensors: the head and the tail took their plain versions
    assert r["counts"] == (lm.lane_maps_op.launches,
                           lm.head_rowsums_op.launches)
