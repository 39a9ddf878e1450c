"""The port's TuSimple evaluation against the JAX package's: LaneEval on the
same files, the backprojection of fitted curves, and the test-set driver
(`make_infer_fn`, `test_model`) on the same weights and images."""

import json
import os

import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.config import train_sh_config as jax_cfg
from lanedetection_end2end_tpu.data import loader as jax_loader
from lanedetection_end2end_tpu.data.dataset import LaneTestSet as JaxTestSet
from lanedetection_end2end_tpu.eval import test_driver as jax_driver
from lanedetection_end2end_tpu.eval.lane_eval import LaneEval as JaxLaneEval
from lanedetection_end2end_tpu.eval.projections import (
    Projections as JaxProjections)
from lanedetection_end2end_tpu.models import LaneNet as JaxLaneNet
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.data import loader
from lanedetection_end2end_tpu_torch.data.dataset import LaneTestSet
from lanedetection_end2end_tpu_torch.data.labels import (
    read_json_lines, write_json_lines)
from lanedetection_end2end_tpu_torch.data.synthetic import make_synthetic_root
from lanedetection_end2end_tpu_torch.eval import test_driver
from lanedetection_end2end_tpu_torch.eval.lane_eval import LaneEval
from lanedetection_end2end_tpu_torch.eval.projections import Projections
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.models.port import (
    variables_from_state_dict)
from test_torch_native_race import require_jax_native
from test_torch_threads import one_torch_thread  # noqa: F401

RESIZE = 32


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    require_jax_native()
    return make_synthetic_root(str(tmp_path_factory.mktemp("synth_eval")),
                               num_train=2, num_test=6, seed=11)


def _perturbed(gt, rng, shift, drop):
    """Predictions from the gt lines: every x moved by up to `shift`
    pixels, a lane dropped with probability `drop`, one spurious lane
    sometimes."""
    preds = []
    for rec in gt:
        lanes = []
        for lane in rec["lanes"]:
            if rng.uniform() < drop:
                continue
            x = np.array(lane, dtype=np.float64)
            x = np.where(x >= 0, x + rng.uniform(-shift, shift, x.shape), x)
            lanes.append(np.round(x).astype(int).tolist())
        if rng.uniform() < 0.3:
            lanes.append(rng.integers(0, 1280, len(rec["h_samples"])).tolist())
        preds.append(dict(rec, lanes=lanes, run_time=20))
    return preds


@pytest.mark.parametrize("shift,drop", [(0, 0.0), (15, 0.2), (40, 0.4)])
def test_lane_eval_matches_jax(root, tmp_path, shift, drop):
    gt_file = root["test_label_file"]
    gt = read_json_lines(gt_file)
    pred_file = str(tmp_path / "pred.json")
    write_json_lines(pred_file, _perturbed(gt, np.random.default_rng(
        shift), shift, drop))
    got = LaneEval.bench_one_submit(pred_file, gt_file)
    assert got == JaxLaneEval.bench_one_submit(pred_file, gt_file)
    if shift == 0:
        assert got[0] == 1.0


def test_lane_eval_bench_cases_match_jax():
    rng = np.random.default_rng(0)
    ys = list(range(160, 720, 10))
    for n_gt, n_pred, run_time in ((4, 4, 20), (5, 4, 20), (2, 5, 20),
                                   (3, 3, 250), (6, 7, 20)):
        gt = rng.integers(-2, 1280, (n_gt, len(ys)))
        pred = (gt[np.arange(n_pred) % n_gt]
                + rng.integers(-30, 30, (n_pred, len(ys)))).tolist()
        gt = gt.tolist()
        assert LaneEval.bench(pred, gt, ys, run_time) == JaxLaneEval.bench(
            pred, gt, ys, run_time)


@pytest.mark.parametrize("resize,order,no_mapping", [
    (32, 3, False), (256, 3, False), (64, 2, False), (32, 1, True),
    (32, 0, False)])
def test_projections_match_jax(resize, order, no_mapping):
    beta = np.random.default_rng(order).normal(
        0, 1, (3, 4, order + 1)).astype(np.float32)
    beta[..., -1] = beta[..., -1] * 50 + resize
    got = Projections(resize, order, no_mapping).compute_coordinates(
        torch.from_numpy(beta)).numpy()
    want = np.asarray(JaxProjections(resize, order, no_mapping)
                      .compute_coordinates(beta))
    assert got.shape == want.shape == (3, 4, 56)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def weights():
    """The port's seeded LaneNet at resize 32 and the same weights in the
    JAX layout, with BatchNorm statistics away from (0, 1)."""
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0)
    with torch.random.fork_rng():
        # the module's initializers draw from the global generator
        torch.manual_seed(0)
        model = LaneNet(cfg, device="cpu")
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif name.endswith("running_mean"):
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
    return model, variables_from_state_dict(model.state_dict(), RESIZE)


def _jax_test_loader(root):
    ts = JaxTestSet(root["test_label_file"], root["test_dir"], RESIZE)
    return jax_loader.get_testloader(ts, 4, nworkers=1)


def _port_test_loader(root):
    ts = LaneTestSet(root["test_label_file"], root["test_dir"], RESIZE)
    return loader.get_testloader(ts, 4, nworkers=1)


def test_infer_fn_matches_jax(root, weights):
    model, variables = weights
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0)
    infer = test_driver.make_infer_fn(model, cfg, Projections(
        RESIZE, cfg.order, device="cpu"))
    jcfg = jax_cfg(resize=RESIZE, reg_ls=1.0)
    jinfer = jax_driver.make_infer_fn(JaxLaneNet(jcfg), jcfg, JaxProjections(
        RESIZE, jcfg.order))
    batch = next(iter(_port_test_loader(root)))
    got = infer(torch.from_numpy(batch["image"])).numpy()
    want = np.asarray(jinfer(variables, batch["image"]))
    assert got.shape == want.shape == (4, 4, 56)
    # the same gating: a point is suppressed on both sides or on neither;
    # the kept x agree to the float32 fit's conditioning (the cubic fit's
    # beta carries the logits' f32 rounding: 3.3e-4 relative measured)
    np.testing.assert_array_equal(got == -2.0, want == -2.0)
    assert (got > -2.0).sum() > 20
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_test_model_matches_jax(root, weights, tmp_path):
    model, variables = weights
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0,
                          test_dir=root["test_dir"])
    jcfg = jax_cfg(resize=RESIZE, reg_ls=1.0, test_dir=root["test_dir"])
    stats = {}
    acc = test_driver.test_model(_port_test_loader(root), model, cfg,
                                 save_path=str(tmp_path / "port"),
                                 verbose=False, stats=stats)
    want = jax_driver.test_model(_jax_test_loader(root), JaxLaneNet(jcfg),
                                 variables, jcfg,
                                 save_path=str(tmp_path / "jax"),
                                 verbose=False)
    assert acc == want
    assert stats["batches"] == 2 and stats["ms_per_batch"] > 0
    a = read_json_lines(str(tmp_path / "port" / "test_set_predictions.json"))
    b = read_json_lines(str(tmp_path / "jax" / "test_set_predictions.json"))
    assert len(a) == len(b) == 6
    # the same records; each lane x is np.round of a float32 value that
    # agrees to ~2e-5 relative (test_infer_fn_matches_jax), so a value near
    # a half pixel may round to neighbouring integers on the two sides
    for ra, rb in zip(a, b):
        la, lb = np.array(ra.pop("lanes")), np.array(rb.pop("lanes"))
        assert ra == rb
        np.testing.assert_array_equal(la == -2, lb == -2)
        assert np.abs(la - lb).max() <= 1


def test_test_model_through_the_engine_and_drawing(root, weights, tmp_path):
    """use_engine serves through FusedLaneNetEngine (its plain versions on
    the CPU, bf16 backbone): predictions within a few pixels of the
    float32 forward's; --draw_testset writes one image per test image."""
    model, _ = weights
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0,
                          test_dir=root["test_dir"], draw_testset=True)
    out = tmp_path / "engine"
    acc = test_driver.test_model(_port_test_loader(root), model, cfg,
                                 save_path=str(out), verbose=False,
                                 use_engine=True)
    assert 0.0 <= acc <= 1.0
    drawn = sorted(os.listdir(out / "example" / "testset"))
    assert drawn == [f"{i}.jpg" for i in range(6)]
    with open(out / "test_set_predictions.json") as f:
        assert len([json.loads(line) for line in f]) == 6


def test_bf16_engine_deviation_on_kaiming_weights_matches_jax():
    """On the Trainer's kaiming-initialized weights the bf16 serving engine
    departs from the f32 LaneNet by more than the JAX package's 1e-2 logit
    bar (tests/test_pallas_wls.py:212-215, which holds on init weights),
    and JAX's own bf16 engine departs as far: max|diff| / max|LaneNet| of
    beta, line and horizon logits for both engines on the same weights and
    images. chip_smoke.py holds the engine on the Trainer's checkpoint at
    beta 3e-2 and logits 1e-1 of max|LaneNet| (ENGINE_BARS_TRAINED)."""
    import jax.numpy as jnp

    from lanedetection_end2end_tpu.models.infer_engine import (
        FusedLaneNetEngine as JaxEngine)
    from lanedetection_end2end_tpu_torch.models.infer_engine import (
        FusedLaneNetEngine)
    from lanedetection_end2end_tpu_torch.models.init import init_weights
    cfg = train_sh_config(resize=RESIZE)
    model = LaneNet(cfg, device="cpu")
    init_weights(model, "kaiming", torch.Generator().manual_seed(0))
    x = torch.rand(4, RESIZE, 2 * RESIZE, 3,
                   generator=torch.Generator().manual_seed(1))
    ref = model(x)
    engine = FusedLaneNetEngine(cfg, device="cpu")
    port = engine(engine.prepare(model.state_dict()), x)
    v = variables_from_state_dict(model.state_dict(), RESIZE)
    jengine = JaxEngine(jax_cfg(resize=RESIZE), interpret=True)
    jax_out = jengine(jengine.prepare(v), v, jnp.asarray(x.numpy()))
    rel = {}
    for key, p, j, r in zip(("beta", "line", "horizon"), port, jax_out,
                            (ref.beta, ref.line_logits, ref.horizon_logits)):
        r = r.numpy()
        scale = np.abs(r).max()
        rel[key] = (np.abs(p.numpy() - r).max() / scale,
                    np.abs(np.asarray(j, np.float32) - r).max() / scale)
    print({k: f"port {a:.2e}, jax {b:.2e}" for k, (a, b) in rel.items()})
    # JAX's own engine misses its 1e-2 logit bar here
    assert rel["line"][1] * np.abs(ref.line_logits.numpy()).max() > 1e-2
    bars = {"beta": 3e-2, "line": 1e-1, "horizon": 1e-1}
    for key, (p, j) in rel.items():
        assert p <= bars[key] and j <= bars[key], (key, p, j)
        # the port departs no further than twice the reference's departure
        assert p <= 2 * j, (key, p, j)
