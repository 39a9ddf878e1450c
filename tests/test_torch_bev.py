"""The BEV profile of the port against the JAX package on the CPU: its
labels and batches, `write_lsq_results`, the weight carrier with the BEV
line heads and the pretraining head, `LaneNet.forward` in the three
phases, the serving engine; and the repair of the 2x2 head's launch at
two lanes (K9 at cout 2), which the CPU's plain versions cannot show, with
the wrappers' launches stubbed as in tests/test_torch_f32_fused.py.

Bars: data, records and weights bit for bit (byte for byte for the
written files); the float32 forward at rtol 1e-4 and 1e-4 of max|ref|
(tests/test_torch_engine.py; the seg phase's argmax maps exactly); the
bf16 engine at the JAX package's own bars, beta < 3e-2 of max|beta| and
logits rtol = atol = 1e-2 (tests/test_pallas_wls.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.config import bev_defaults as jax_bev
from lanedetection_end2end_tpu.data import dataset as jax_dataset
from lanedetection_end2end_tpu.data import loader as jax_loader
from lanedetection_end2end_tpu.data import synthetic as jax_synthetic
from lanedetection_end2end_tpu.eval.results import (
    write_lsq_results as jax_write_lsq_results)
from lanedetection_end2end_tpu.geometry import homography as jax_geometry
from lanedetection_end2end_tpu.models import LaneNet as JaxLaneNet
from lanedetection_end2end_tpu.models.infer_engine import (
    FusedLaneNetEngine as JaxEngine)
from lanedetection_end2end_tpu.models.port import port_torch_state_dict
from lanedetection_end2end_tpu_torch import geometry
from lanedetection_end2end_tpu_torch.config import bev_defaults, bp_defaults
from lanedetection_end2end_tpu_torch.data import dataset, loader, synthetic
from lanedetection_end2end_tpu_torch.data.labels import (
    read_json_lines, write_json_lines)
from lanedetection_end2end_tpu_torch.eval.results import write_lsq_results
from lanedetection_end2end_tpu_torch.models.infer_engine import (
    FusedLaneNetEngine)
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.models.port import (
    state_dict_from_variables, variables_from_state_dict)
from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
from lanedetection_end2end_tpu_torch.train import steps as tsteps
from lanedetection_end2end_tpu_torch.train.optim import define_optim
from test_torch_engine import _check_serving, _randomize_bn
from test_torch_f32_fused import BF16, F32, SUFFIX, Stubs, _rn

RESIZE = 32


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return synthetic.make_synthetic_root(
        str(tmp_path_factory.mktemp("bev_data")), num_train=10, num_test=2,
        seed=11)


# ----------------------------------------------------------------------
# Data
# ----------------------------------------------------------------------

def _bev_datasets(root, nclasses, image_dtype, valid_idx=(1, 4)):
    kw = dict(valid_idx=list(valid_idx), resize=RESIZE, nclasses=nclasses,
              flip_on=True, image_dtype=image_dtype,
              curves_file=root["curves_file"], line_file=root["line_file"])
    return (dataset.LaneDataset("bev", root["image_dir"], root["gt_dir"],
                                **kw),
            jax_dataset.LaneDataset("bev", root["image_dir"], root["gt_dir"],
                                    **kw))


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("nclasses,image_dtype", [(2, "uint8"),
                                                  (4, "float32")])
def test_bev_dataset_items_are_bit_equal(root, nclasses, image_dtype):
    a, b = _bev_datasets(root, nclasses, image_dtype)
    assert len(a) == len(b) == 10
    for i in range(len(a)):
        for flip in (False, True):
            got = a.__getitem__(i, flip=flip)
            _same(got, b.__getitem__(i, flip=flip))
            assert got["params"].shape == (4, 3)


def test_bev_loader_batches_are_bit_equal(root):
    a, b = _bev_datasets(root, 4, "uint8", valid_idx=(0, 5))
    idx = [1, 2, 3, 4, 6, 7, 8, 9]
    la = loader.Loader(a, idx, 4, shuffle=True, flip=True, nworkers=2,
                       seed=5)
    lb = jax_loader.Loader(b, idx, 4, shuffle=True, flip=True, nworkers=2,
                           seed=5, process_index=0, process_count=1)
    la.set_epoch(1)
    lb.set_epoch(1)
    got, want = list(la), list(lb)
    assert len(got) == len(want) == 2
    for x, y in zip(got, want):
        _same(x, y)


def test_bev_synthetic_lanes_batches_match():
    got = synthetic.SyntheticLanes(2, resize=RESIZE, profile="bev",
                                   seed=3).batch()
    want = jax_synthetic.SyntheticLanes(2, resize=RESIZE, profile="bev",
                                        seed=3).batch()
    _same(got, want)
    assert got["params"].shape == (2, 4, 3) and got["line"].dtype == np.int32


# ----------------------------------------------------------------------
# write_lsq_results
# ----------------------------------------------------------------------

def test_geometry_helpers_match_jax():
    got, want = geometry.eval_matrices_normalized(), \
        jax_geometry.eval_matrices_normalized()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    M = got[1]
    x, y = np.linspace(0, 1, 7), np.linspace(0.3, 1, 7)
    for a, b in zip(geometry.homogeneous_transform(M, x, y),
                    jax_geometry.homogeneous_transform(M, x, y)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def records(root, tmp_path_factory):
    """Validation records as the BEV Trainer writes them: the gt curve
    file's lines with fitted params (order 2, and order 1 for the last
    two records), the line branch's slots and the horizon estimate."""
    rng = np.random.default_rng(2)
    recs = []
    for i, rec in enumerate(read_json_lines(root["curves_file"])):
        params = np.asarray(rec["poly_params"]) + rng.normal(0, 0.01, (4, 3))
        if i >= 8:
            params = params[:, 1:]
        line_id = rng.integers(0, 2, 4).tolist()
        if i == 0:
            line_id[0] = line_id[3] = 0
        recs.append(dict(rec, params=params.tolist(), line_id=line_id,
                         horizon_est=rng.uniform(0, 1, RESIZE).tolist()))
    path = str(tmp_path_factory.mktemp("records") / "validation_set_dst.json")
    write_json_lines(path, recs)
    return path


@pytest.mark.parametrize("branches,horizon,no_ortho", [
    (False, False, False), (True, False, False), (True, True, False),
    (False, False, True)])
def test_write_lsq_results_is_byte_identical(records, tmp_path, branches,
                                             horizon, no_ortho):
    a, b = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    write_lsq_results(records, a, 4, branches, horizon, RESIZE,
                      no_ortho=no_ortho)
    jax_write_lsq_results(records, b, 4, branches, horizon, RESIZE,
                          no_ortho=no_ortho)
    with open(a, "rb") as f, open(b, "rb") as g:
        got, want = f.read(), g.read()
    assert got == want
    lines = read_json_lines(a)
    assert len(lines) == 10 and all(r["run_time"] == 20 for r in lines)
    assert any(x != -2 for r in lines for lane in r["lanes"] for x in lane)


# ----------------------------------------------------------------------
# Weights: the BEV line heads and the pretraining head
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def bev_variables():
    cfg = jax_bev(resize=RESIZE, nclasses=4, clas=True, pretrained=True)
    v = jax.device_get(JaxLaneNet(cfg).init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32), v)


def test_bev_carrier_inverts_port_torch_state_dict(bev_variables):
    v = bev_variables
    sd = state_dict_from_variables(v, profile="bev")
    for k in ("net.decoder.output_conv2.weight",
              "line_classification.fully_connected_line4.weight"):
        assert k in sd, k
    back = port_torch_state_dict({k: t.numpy() for k, t in sd.items()},
                                 profile="bev", resize=RESIZE)
    want = jax.tree_util.tree_leaves_with_path(v)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))
    model = LaneNet(bev_defaults(resize=RESIZE, nclasses=4, clas=True,
                                 pretrained=True), device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)  # strict


def test_bev_carrier_round_trips(bev_variables):
    v = bev_variables
    back = variables_from_state_dict(
        state_dict_from_variables(v, profile="bev"), RESIZE)
    want = jax.tree_util.tree_leaves_with_path(v)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_carrier_refuses_leaves_it_has_no_place_for(bev_variables):
    v = bev_variables
    # the BEV line heads read as the BP profile: fc_line2..4 unplaced
    with pytest.raises(ValueError, match="fc_line2"):
        state_dict_from_variables(v, profile="bp")
    extra = jax.tree_util.tree_map(lambda a: a, v)
    extra["params"]["erfnet"]["decoder"]["output_conv3"] = \
        extra["params"]["erfnet"]["decoder"]["output_conv2"]
    with pytest.raises(ValueError, match="output_conv3"):
        state_dict_from_variables(extra, profile="bev")
    with pytest.raises(KeyError, match="no place"):
        variables_from_state_dict(
            {"net.decoder.output_conv3.weight": torch.zeros(16, 5, 2, 2)},
            RESIZE)


# ----------------------------------------------------------------------
# LaneNet.forward in the three phases, and the engine
# ----------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(2, False), (4, True)],
                ids=["2lanes", "4lanes-heads"])
def phases(request):
    nclasses, clas = request.param
    kw = dict(resize=RESIZE, nclasses=nclasses, clas=clas, pretrained=True,
              reg_ls=1.0)
    jnet = JaxLaneNet(jax_bev(**kw), dtype=jnp.float32)
    rng = np.random.default_rng(nclasses)
    v = _randomize_bn(jnet.init(jax.random.PRNGKey(nclasses)), rng)
    x = rng.uniform(size=(2, RESIZE, 2 * RESIZE, 3)).astype(np.float32)
    net = LaneNet(bev_defaults(**kw), device="cpu")
    net.load_state_dict(state_dict_from_variables(v, profile="bev"))
    out = {}
    for phase in ("skip", "seg", "e2e"):
        out[phase] = (net.forward(torch.from_numpy(x), phase=phase),
                      jnet.apply(v, jnp.asarray(x), phase=phase,
                                 train=False))
    return nclasses, clas, out


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("phase", ["skip", "seg", "e2e"])
def test_bev_forward_matches_jax_in_each_phase(phases, phase):
    nclasses, clas, out = phases
    got, want = out[phase]
    # skip and seg read the pretraining head (background + lanes), e2e
    # the main one
    channels = nclasses + (phase != "e2e")
    assert got.seg_logits.shape[-1] == channels
    _close(got.seg_logits, want.seg_logits)
    _close(got.encoder_features, want.encoder_features)
    if phase == "skip":
        assert got.beta is None and want.beta is None
        return
    if phase == "seg":  # the argmax maps, class index as weight, exactly
        np.testing.assert_array_equal(got.weightmaps.numpy(),
                                      np.asarray(want.weightmaps))
    else:
        _close(got.weightmaps, want.weightmaps)
    _close(got.beta, want.beta)
    heads = clas and phase == "e2e"
    assert (got.line_logits is None) == (not heads)
    if heads:
        assert got.line_logits.shape == (2, 3, 4)
        _close(got.line_logits, want.line_logits)
        _close(got.horizon_logits, want.horizon_logits)


@pytest.fixture(scope="module")
def engine_run():
    resize, batch = 64, 2
    kw = dict(resize=resize, nclasses=4, clas=True, reg_ls=1.0)
    jcfg = jax_bev(**kw)
    jnet = JaxLaneNet(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    v = _randomize_bn(jnet.init(jax.random.PRNGKey(5)), rng)
    x = rng.uniform(size=(batch, resize, 2 * resize, 3)).astype(np.float32)
    ref = jnet.apply(v, jnp.asarray(x), phase="e2e", train=False)
    jeng = JaxEngine(jcfg, dtype=jnp.float32, interpret=True, mode="full")
    jpacked = jeng.prepare(v)
    jout = jax.jit(lambda p, vv, xx: jeng(p, vv, xx))(jpacked, v, x)
    eng = FusedLaneNetEngine(bev_defaults(**kw), device="cpu")
    out = eng(eng.prepare(state_dict_from_variables(v, profile="bev")),
              torch.from_numpy(x))
    return ([t.numpy() for t in out], [np.asarray(a) for a in jout], ref,
            eng)


def test_bev_engine_matches_jax_engine_and_lanenet(engine_run):
    out, jout, ref, eng = engine_run
    assert eng.fitter.separable
    assert out[0].shape == (2, 4, 3) and out[1].shape == (2, 3, 4)
    _check_serving(out, *jout)
    _check_serving(out, ref.beta, ref.line_logits, ref.horizon_logits)


# ----------------------------------------------------------------------
# The repair: K9's head at two lanes reaches its launch
# ----------------------------------------------------------------------

@pytest.fixture
def stubs(monkeypatch):
    s = Stubs()
    monkeypatch.setattr(lm, "kernel", s.kernel)
    monkeypatch.setattr(lm, "launch", s.launch)
    monkeypatch.setattr(lm, "check_cuda", s.check_cuda)
    monkeypatch.setattr(lm.lane_maps_op, "launches", 0)
    monkeypatch.setattr(lm.lane_maps_op, "bwd_launches", 0)
    return s


@pytest.mark.parametrize("dt", [F32, BF16], ids=["float32", "bfloat16"])
def test_two_lane_head_reaches_its_launch(stubs, dt):
    """The eval step's head at cout 2 (f32 out, no moments), forward and
    backward, asks for the dtype's own C entries; before the repair both
    raised on the moment channels they do not use."""
    rng = np.random.default_rng(0)
    x = _rn(rng, 2, 3, 5, 16, dtype=dt)
    weight, bias = _rn(rng, 16, 2, 2, 2), _rn(rng, 2)
    y, mom = lm._lane_maps_fwd_cuda(x, weight, bias, 2, F32, False)
    assert mom is None and y.shape == (2, 6, 10, 2) and y.dtype == F32
    dx, dweight, dbias = lm.lane_maps_bwd_kernel(
        x, None, _rn(rng, 2, 6, 10, 2), None, weight, 2)
    assert dx.dtype == dt and dweight.shape == (16, 2, 2, 2)
    assert [(n, s) for n, s, _ in stubs.calls] == [
        ("lane_maps_op", "ld_lane_maps_op_fwd" + SUFFIX[dt]),
        ("lane_maps_op", "ld_lane_maps_op_bwd" + SUFFIX[dt])]
    assert (lm.lane_maps_op.launches, lm.lane_maps_op.bwd_launches) == (1, 1)


def test_two_lane_moments_still_raise_before_any_launch(stubs):
    rng = np.random.default_rng(1)
    x = _rn(rng, 2, 3, 5, 16)
    weight, bias = _rn(rng, 16, 2, 2, 2), _rn(rng, 2)
    with pytest.raises(ValueError, match="channels not in"):
        lm._lane_maps_fwd_cuda(x, weight, bias, 2, F32, True)
    with pytest.raises(ValueError, match="channels not in"):
        lm.lane_maps_bwd_kernel(x, _rn(rng, 2, 6, 10, 2),
                                _rn(rng, 2, 6, 10, 2), _rn(rng, 2, 2),
                                weight, 2)
    assert stubs.calls == []


@pytest.mark.parametrize("cfg", [
    bev_defaults(resize=RESIZE, batch_size=2, nclasses=2),
    bp_defaults(resize=RESIZE, batch_size=2, nclasses=2)],
    ids=["bev", "bp"])
def test_two_lane_steps_run_on_the_cpu(cfg):
    """make_eval_step and make_train_step of both profiles' 2-lane
    defaults: finite metrics, beta (2, 2, order + 1)."""
    torch.manual_seed(0)
    net = LaneNet(cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.integers(
        0, 256, (2, RESIZE, 2 * RESIZE, 3), dtype=np.uint8)),
        "horizon": torch.zeros(2, RESIZE)}
    if cfg.profile == "bev":
        batch["params"] = torch.rand(2, 4, 3)
    else:
        batch["lanes"] = 2 * RESIZE * torch.rand(2, 4, 56)
        batch["valid_points"] = torch.ones(2, 4, 56)
    metrics, outputs = tsteps.make_eval_step(net, cfg, device="cpu")(batch)
    assert outputs["beta"].shape == (2, 2, cfg.order + 1)
    opt = define_optim(net.parameters(), "adam", 1e-4)
    step = tsteps.make_train_step(net, cfg, opt, device="cpu")
    for m in (metrics, step(batch)):
        assert all(torch.isfinite(v) for v in m.values())
    assert ("exact_area" in metrics) == (cfg.profile == "bev")
