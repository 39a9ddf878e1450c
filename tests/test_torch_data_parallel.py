"""Data parallelism on the CPU: two gloo ranks against one process and
against the JAX package's sharded step.

One launch of two ranks (`parallel/launch.py::spawn`, one torch thread
each) runs every rank-side check of the module and returns its readings;
the tests compare them here with one process on the whole batch:

- the collectives in float64: `all_reduce_mean` forward and backward,
  `erfnet.BatchNorm2d` and `packed_graph.bn_mul_add` with a group, at
  1e-12 of one process on the concatenated batch (a rank's input gradient
  is the gradient of the sum of the ranks' losses, and so are its
  parameter gradients summed over the ranks: where every rank takes the
  same loss of the global moments, twice one process's);
- the packed e2e step (train_sh_config at resize 32, global batch 8, 4 a
  rank, float32, SGD, dropout off, plain versions of K6-K10): against
  JAX's `make_train_step(mesh=make_mesh(2))` with `packed_train=True` at
  JAX's own bars (tests/test_packed_graph.py: loss rtol 5e-3, update
  cosine > 0.99, norm ratio 0.95-1.05, BatchNorm running statistics atol
  1e-4 / rtol 1e-3), JAX's side on its jnp forms (PACKED_PALLAS unset on
  the CPU, as that test runs it; tests/test_fused_blocks.py pins them to
  the Pallas kernels); and against the port's one-process step on the
  same 8 images: update cosine 0.995 as drawn and 0.99999 with every bn2
  scale x 0.1 (ROADMAP's whole-step bars), the heads' losses rtol 1e-4,
  the total loss rtol 1e-4 damped and 5e-4 as drawn, the two ranks'
  parameters and statistics bit for bit equal. As drawn, the total loss
  (the backprojection fit's) does not hold 1e-4 under any change of
  summation order: one process on the same batch with its halves swapped
  moved it by 3.4e-5 and, over four seeds, 8e-6 to 1.1e-4; two ranks
  moved it by 1.4e-6 to 1.2e-4; damped, the swap moves it by 1e-5;
- the control, in the same launch: the packed step with every share of
  `train/steps.py::_shares` forced to 1 (the ranks average their halves'
  ratios, as JAX's packed shard_map step does) must fail the total loss
  bars (read 1.3e-3 as drawn, 1.9e-3 damped), the eval step's loss bar
  (1.3e-3, 9.5e-4) and the damped cosine (0.99952);
- the packed step with the learned homography (`LaneNet.apply_packed`,
  the default path of that option since the port's packed path fits
  each image's matrices; the heads' and `HomographyHead`'s BatchNorms,
  `_shares` in its backprojection loss) at the same bars;
- the eval step: metrics and outputs gathered in row order against one
  process;
- the engine's `sharded_call` against one call on the 8 images.

The Loader's rank rows and the Trainer's device-count rules need no
ranks. The Trainer over two ranks and `main_torch.py --num_devices` are
in tests/test_torch_trainer_dp.py.
"""

import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.models.erfnet import BatchNorm2d
from lanedetection_end2end_tpu_torch.models.infer_engine import (
    FusedLaneNetEngine)
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.ops.packed_graph import bn_mul_add
from lanedetection_end2end_tpu_torch.parallel import (
    all_reduce_mean, local_rows, spawn)
from lanedetection_end2end_tpu_torch.parallel.mesh import local_slice
from lanedetection_end2end_tpu_torch.train import steps as tsteps
from lanedetection_end2end_tpu_torch.train.optim import define_optim
from test_torch_threads import one_torch_thread  # noqa: F401

RESIZE, BATCH = 32, 8
# the two-rank step's total loss (rtol) and update cosine (least) against
# one process, as drawn and damped (keyed by `damped`)
LOSS_RTOL, COSINE = {False: 5e-4, True: 1e-4}, {False: 0.995, True: 0.99999}
CFGS = {"packed": dict(), "homography": dict(learn_homography=True)}


def make_batch(rng, n=BATCH):
    """A compact batch; the two halves count different numbers of valid
    points, by which the backprojection loss divides."""
    return {
        "image": rng.integers(0, 256, (n, RESIZE, 2 * RESIZE, 3),
                              dtype=np.uint8),
        "flip": rng.uniform(size=n) > 0.5,
        "lanes": rng.uniform(0, 2 * RESIZE, (n, 4, 56)).astype(np.float32),
        "valid_points": (rng.uniform(size=(n, 4, 56)) > 0.3).astype(
            np.float32),
        "line": (rng.uniform(size=(n, 4)) > 0.5).astype(np.float32),
        "horizon": (rng.uniform(size=(n, RESIZE)) > 0.9).astype(np.float32)}


def cfg_of(name):
    return train_sh_config(resize=RESIZE, batch_size=BATCH, reg_ls=1.0,
                           optimizer="sgd", **CFGS[name])


def weights(name, damped, seed=0):
    """The model's seeded weights with BatchNorm off identity (scale,
    bias and running statistics drawn), every bn2 scale x 0.1 if
    `damped`."""
    torch.manual_seed(seed)
    net = LaneNet(cfg_of(name), device="cpu")
    rng = np.random.default_rng(seed)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    for mod_name, m in net.named_modules():
        if isinstance(m, BatchNorm2d):
            n, p = m.num_features, mod_name + "."
            sd[p + "weight"] = torch.from_numpy(rng.uniform(0.8, 1.2, n))
            sd[p + "bias"] = torch.from_numpy(rng.normal(0, 0.1, n))
            sd[p + "running_mean"] = torch.from_numpy(rng.normal(0, 0.1, n))
            sd[p + "running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, n))
            if damped and mod_name.endswith("bn2"):
                sd[p + "weight"] = sd[p + "weight"] * 0.1
    return {k: v.float() if v.is_floating_point() else v
            for k, v in sd.items()}


def run_step(name, sd, batch, group=None):
    """One eval step and one SGD train step (dropout off) on `batch` (this
    rank's rows where `group` is set) -> readings."""
    cfg = cfg_of(name)
    net = LaneNet(cfg, device="cpu")
    net.load_state_dict(sd)
    opt = define_optim(net.parameters(), cfg.optimizer, cfg.learning_rate)
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    emetrics, eout = tsteps.make_eval_step(net, cfg, device="cpu",
                                           group=group)(tbatch)
    metrics = tsteps.make_train_step(net, cfg, opt, device="cpu",
                                     group=group)(tbatch, None)
    after = {k: v.detach().clone() for k, v in net.state_dict().items()}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.numpy() for k, v in after.items()},
            "eval_metrics": {k: float(v) for k, v in emetrics.items()},
            "eval_out": {k: v.numpy() for k, v in eout.items()}}


def primitives(x, c, w, b, group=None):
    """all_reduce_mean, BatchNorm2d and bn_mul_add in float64 on `x`
    (this rank's rows where `group` is set) -> readings."""
    sl = local_slice(x.shape[0], group)
    out = {}
    a = torch.tensor(x[sl], requires_grad=True)
    y = all_reduce_mean(a, group)
    (y * torch.tensor(c[sl])).sum().backward()
    out["mean"], out["mean_dx"] = y.detach().numpy(), a.grad.numpy()

    bn = BatchNorm2d(x.shape[1], eps=1e-3).double().train()
    bn.sync_group = group
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(w))
        bn.bias.copy_(torch.tensor(b))
    a = torch.tensor(x[sl], requires_grad=True)
    y = bn(a)
    (y * torch.tensor(c[sl])).sum().backward()
    out.update(bn_y=y.detach().numpy(), bn_dx=a.grad.numpy(),
               bn_dw=bn.weight.grad.numpy(),
               bn_db=bn.bias.grad.numpy(),
               bn_stats=np.stack([bn.running_mean.numpy(),
                                  bn.running_var.numpy()]))

    bn.zero_grad()
    a = torch.tensor(x[sl], requires_grad=True)
    flat = a.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
    mom = torch.stack([flat.sum(0), (flat * flat).sum(0)])
    mul, add = bn_mul_add(mom, bn, flat.shape[0], True)
    (mul * torch.tensor(w) + add * torch.tensor(b)).sum().backward()
    out.update(mul=mul.detach().numpy(), add=add.detach().numpy(),
               mom_dx=a.grad.numpy(), mom_dw=bn.weight.grad.numpy())
    return out


def engine_call(sd, images, group=None):
    cfg = cfg_of("packed")
    engine = FusedLaneNetEngine(cfg, device="cpu")
    packed = engine.prepare(sd)
    fn = engine.sharded_call(group) if group is not None else (
        lambda p, x: engine(p, x))
    x = torch.from_numpy(images).float() / 255.0
    return [t.float().numpy() for t in fn(packed, x)]


def _ranks(dp, payload):
    """Every rank-side check of the module, on rank `dp`."""
    torch.set_num_threads(1)
    g = dp.group
    out = {"prim": primitives(*payload["prim"], group=g)}
    for key, (name, sd) in payload["steps"].items():
        out[key] = run_step(name, sd, local_rows(payload["batch"], g), g)
    out["engine"] = engine_call(payload["steps"]["packed-drawn"][1],
                                payload["batch"]["image"], g)
    shares, tsteps._shares = tsteps._shares, _unshared
    try:
        for kind in ("drawn", "damped"):
            out[f"unshared-{kind}"] = run_step(
                "packed", payload["steps"][f"packed-{kind}"][1],
                local_rows(payload["batch"], g), g)
    finally:
        tsteps._shares = shares
    return out


def _unshared(counts, group):
    """The fault `train/steps.py::_shares` repairs, planted as the control:
    every share 1, so the ranks average their halves' ratios (JAX's packed
    shard_map step) where one process divides the sums."""
    return torch.ones_like(counts, dtype=torch.float32)


@pytest.fixture(scope="module")
def run():
    """The two ranks' readings and one process's on the same inputs."""
    rng = np.random.default_rng(3)
    prim = (rng.normal(size=(4, 3, 5, 6)), rng.normal(size=(4, 3, 5, 6)),
            rng.uniform(0.5, 1.5, 3), rng.normal(size=3))
    steps = {f"{name}-{kind}": (name, weights(name, kind == "damped"))
             for name in CFGS for kind in ("drawn", "damped")}
    batch = make_batch(rng)
    payload = {"prim": prim, "steps": steps, "batch": batch}
    ranks = spawn(_ranks, 2, args=(payload,))
    one = {"prim": primitives(*prim)}
    for key, (name, sd) in steps.items():
        one[key] = run_step(name, sd, batch)
    one["engine"] = engine_call(steps["packed-drawn"][1], batch["image"])
    return {"ranks": ranks, "one": one, "payload": payload}


# ----------------------------------------------------------------------
# The collectives
# ----------------------------------------------------------------------

def _rows(rank_values):
    return np.concatenate(rank_values, axis=0)


def test_all_reduce_mean_forward_and_backward(run):
    x, c, _, _ = run["payload"]["prim"]
    p = [r["prim"] for r in run["ranks"]]
    want = (x[:2] + x[2:]) / 2
    for r in p:
        np.testing.assert_allclose(r["mean"], want, rtol=0, atol=1e-12)
        np.testing.assert_allclose(r["mean_dx"], (c[:2] + c[2:]) / 2,
                                   rtol=0, atol=1e-12)


def test_batchnorm_with_a_group_is_the_whole_batch(run):
    p, one = [r["prim"] for r in run["ranks"]], run["one"]["prim"]
    for k in ("bn_y", "bn_dx"):
        np.testing.assert_allclose(_rows([r[k] for r in p]), one[k],
                                   rtol=0, atol=1e-12, err_msg=k)
    for k in ("bn_dw", "bn_db"):
        np.testing.assert_allclose(p[0][k] + p[1][k], one[k], rtol=0,
                                   atol=1e-12, err_msg=k)
    for r in p:
        np.testing.assert_allclose(r["bn_stats"], one["bn_stats"], rtol=0,
                                   atol=1e-12)


def test_bn_mul_add_with_a_group_is_the_whole_batch(run):
    p, one = [r["prim"] for r in run["ranks"]], run["one"]["prim"]
    for r in p:
        for k in ("mul", "add"):
            np.testing.assert_allclose(r[k], one[k], rtol=0, atol=1e-12)
    # both ranks take the same loss of the global moments: the sum of the
    # ranks' losses is twice the one process's
    np.testing.assert_allclose(_rows([r["mom_dx"] for r in p]),
                               2 * one["mom_dx"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(p[0]["mom_dw"] + p[1]["mom_dw"],
                               2 * one["mom_dw"], rtol=0, atol=1e-12)


# ----------------------------------------------------------------------
# The steps against one process
# ----------------------------------------------------------------------

def update_cosine(a, b, old):
    """Cosine and norm ratio of two updates (new - old) of the
    parameters."""
    keys = [k for k in old if "running" not in k and "num_batches" not in k]
    da = np.concatenate([(a[k] - old[k].numpy()).ravel() for k in keys])
    db = np.concatenate([(b[k] - old[k].numpy()).ravel() for k in keys])
    na, nb = np.linalg.norm(da), np.linalg.norm(db)
    return float(da @ db / (na * nb)), float(na / nb)


@pytest.mark.parametrize("key", sorted(f"{n}-{k}" for n in CFGS
                                       for k in ("drawn", "damped")))
def test_two_ranks_step_as_one_process(run, key):
    r0, r1 = (r[key] for r in run["ranks"])
    one = run["one"][key]
    old = run["payload"]["steps"][key][1]
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k], k)
    assert r0["metrics"] == r1["metrics"]
    assert sorted(r0["metrics"]) == sorted(one["metrics"])
    damped = key.endswith("damped")
    for k, v in one["metrics"].items():
        rtol = LOSS_RTOL[damped] if k == "loss" else 1e-4
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=rtol,
                                   atol=1e-6, err_msg=k)
    cos, ratio = update_cosine(r0["state"], one["state"], old)
    assert cos > COSINE[damped], cos
    assert 0.95 < ratio < 1.05, ratio
    for k, v in one["state"].items():
        if "running" in k:
            np.testing.assert_allclose(r0["state"][k], v, atol=1e-4,
                                       rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("kind", ["drawn", "damped"])
def test_the_bars_catch_unshared_ratios(run, kind):
    """The control: with every share 1 the ranks' loss is the mean of
    their halves' backprojection ratios, not the global batch's ratio; the
    total loss bars of the train and eval steps (and damped, the cosine)
    must see it."""
    got = run["ranks"][0][f"unshared-{kind}"]
    one = run["one"][f"packed-{kind}"]
    damped = kind == "damped"

    def rel(a, b):
        return abs(a["loss"] - b["loss"]) / abs(b["loss"])

    assert rel(got["metrics"], one["metrics"]) > LOSS_RTOL[damped]
    assert rel(got["eval_metrics"], one["eval_metrics"]) > 1e-4
    if damped:
        cos, _ = update_cosine(got["state"], one["state"],
                               run["payload"]["steps"][f"packed-{kind}"][1])
        assert cos <= COSINE[damped], cos


@pytest.mark.parametrize("key", ["packed-drawn", "homography-drawn"])
def test_eval_step_gathers_the_global_batch(run, key):
    r0, r1 = (r[key] for r in run["ranks"])
    one = run["one"][key]
    assert r0["eval_metrics"] == r1["eval_metrics"]
    for k, v in one["eval_metrics"].items():
        np.testing.assert_allclose(r0["eval_metrics"][k], v, rtol=1e-4,
                                   err_msg=k)
    assert sorted(r0["eval_out"]) == sorted(one["eval_out"])
    for k, v in one["eval_out"].items():
        assert r0["eval_out"][k].shape == v.shape == (BATCH,) + v.shape[1:]
        np.testing.assert_array_equal(r0["eval_out"][k], r1["eval_out"][k])
        np.testing.assert_allclose(r0["eval_out"][k], v, rtol=1e-4,
                                   atol=1e-4 * np.abs(v).max(), err_msg=k)


def test_sharded_engine_call_is_the_single_call(run):
    """Each rank runs its 4 images; beta and the heads' logits, gathered,
    match the single call on the 8 within 1e-5 of their max (one torch
    thread on both sides)."""
    got0, got1, want = (run["ranks"][0]["engine"], run["ranks"][1]["engine"],
                        run["one"]["engine"])
    for a, b, w in zip(got0, got1, want):
        assert a.shape == w.shape and a.shape[0] == BATCH
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


# ----------------------------------------------------------------------
# The packed step against JAX's sharded step
# ----------------------------------------------------------------------

def test_two_ranks_step_matches_jax_two_device_step(run, monkeypatch):
    import jax
    import jax.numpy as jnp

    from lanedetection_end2end_tpu.config import train_sh_config as jax_sh
    from lanedetection_end2end_tpu.models import LaneNet as JaxLaneNet
    from lanedetection_end2end_tpu.parallel import (
        make_mesh, replicate, shard_batch)
    from lanedetection_end2end_tpu.train import define_optim as jax_optim
    from lanedetection_end2end_tpu.train import make_train_step
    from lanedetection_end2end_tpu.train.state import init_train_state
    from lanedetection_end2end_tpu_torch.models.port import (
        variables_from_state_dict)
    from test_torch_train_step import flat

    for k in ("PACKED_PALLAS", "PACKED_FUSED_BLOCKS", "PACKED_FUSED_MAPS",
              "PACKED_BANDED"):
        monkeypatch.delenv(k, raising=False)
    sd = run["payload"]["steps"]["packed-drawn"][1]
    v = variables_from_state_dict(sd, RESIZE)
    jcfg = jax_sh(resize=RESIZE, batch_size=BATCH, reg_ls=1.0,
                  packed_train=True)
    jnet = JaxLaneNet(jcfg, dtype=jnp.float32)
    tx = jax_optim("sgd", jcfg.learning_rate)
    mesh = make_mesh(2)
    step = make_train_step(jnet, jcfg, tx, "e2e", donate=False, mesh=mesh)
    batch = {k: jnp.asarray(a) for k, a in run["payload"]["batch"].items()}
    state, metrics = step(replicate(init_train_state(v, tx), mesh),
                          shard_batch(batch, mesh), None)

    got = run["ranks"][0]["packed-drawn"]
    np.testing.assert_allclose(got["metrics"]["loss"],
                               float(metrics["loss"]), rtol=5e-3)
    new = variables_from_state_dict(
        {k: torch.from_numpy(a) for k, a in got["state"].items()}, RESIZE)
    p0, p1, pj = (flat(v["params"]), flat(new["params"]),
                  flat(jax.device_get(state.params)))
    assert set(p1) == set(pj)
    d1 = np.concatenate([(p1[k] - p0[k]).ravel() for k in sorted(pj)])
    dj = np.concatenate([(np.asarray(pj[k]) - p0[k]).ravel()
                         for k in sorted(pj)])
    n1, nj = np.linalg.norm(d1), np.linalg.norm(dj)
    assert d1 @ dj / (n1 * nj) > 0.99, d1 @ dj / (n1 * nj)
    assert 0.95 < n1 / nj < 1.05, n1 / nj
    s1, sj = flat(new["batch_stats"]), flat(jax.device_get(state.batch_stats))
    assert set(s1) == set(sj)
    for k in sj:
        np.testing.assert_allclose(s1[k], np.asarray(sj[k]), atol=1e-4,
                                   rtol=1e-3, err_msg=k)
