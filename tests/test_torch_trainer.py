"""The port's Trainer and what it is built from, against the JAX package:
the epoch schedules, the init schemes' fans and spreads, checkpoint save,
resume and best, and one JAX Trainer (no mesh) on the same data: with its
weights carried over, the port's `validate` loss and `test_model`
accuracy match it, and a 2-epoch `fit` writes the same set of files. The
two fits' losses differ (dropout draws from different generators), so the
loop is held by its files and its finite losses."""

import os
import re

import jax
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.config import train_sh_config as jax_cfg
from lanedetection_end2end_tpu.data import dataset as jax_dataset
from lanedetection_end2end_tpu.data import loader as jax_loader
from lanedetection_end2end_tpu.eval import test_driver as jax_driver
from lanedetection_end2end_tpu.models import init as jax_init
from lanedetection_end2end_tpu.train import optim as jax_optim
from lanedetection_end2end_tpu.train.driver import Trainer as JaxTrainer
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.data import dataset, loader
from lanedetection_end2end_tpu_torch.data.labels import (
    load_valid_set_file_all, read_json_lines)
from lanedetection_end2end_tpu_torch.data.synthetic import make_synthetic_root
from lanedetection_end2end_tpu_torch.eval import test_driver
from lanedetection_end2end_tpu_torch.models import init
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.models.port import (
    _flax_path, state_dict_from_variables)
from lanedetection_end2end_tpu_torch.train import checkpoint, driver
from lanedetection_end2end_tpu_torch.train.optim import Scheduler

RESIZE = 32


# ----------------------------------------------------------------------
# Schedules
# ----------------------------------------------------------------------

def test_lambda_schedule():
    s = Scheduler("lambda", 1.0, niter=5, niter_decay=9)
    assert s.epoch_lr(0) == pytest.approx(1.0)
    assert s.epoch_lr(4) == pytest.approx(1.0)
    assert s.epoch_lr(5) == pytest.approx(1.0 - 1 / 10)
    assert s.epoch_lr(13) == pytest.approx(1.0 - 9 / 10)


def test_step_schedule():
    s = Scheduler("step", 1.0, gamma=0.5, lr_decay_iters=2)
    assert [s.epoch_lr(e) for e in range(5)] == [1.0, 1.0, 0.5, 0.5, 0.25]


def test_plateau_schedule():
    s = Scheduler("plateau", 1.0, gamma=0.1, lr_decay_iters=1)
    assert s.plateau_step(1.0) == 1.0
    assert s.plateau_step(1.0) == 1.0
    assert s.plateau_step(1.0) == pytest.approx(0.1)
    assert s.plateau_step(0.01) == pytest.approx(0.1)


def _torch_plateau(scores):
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=1.0)
    sched = torch.optim.lr_scheduler.ReduceLROnPlateau(
        opt, mode="min", factor=0.1, threshold=1e-4, patience=1)
    for s in scores:
        sched.step(s)
    return opt.param_groups[0]["lr"]


@pytest.mark.parametrize("scores,port_lr,torch_lr", [
    # large scores: the absolute threshold counts every 0.05 drop as an
    # improvement, torch's relative one (best * (1 - 1e-4)) none
    ([1000, 999.95, 999.9, 999.85], 1.0, 0.1),
    # small scores: the absolute threshold counts none, torch's all
    ([1e-3, 9.9e-4, 9.8e-4, 9.7e-4], 0.1, 1.0)])
def test_plateau_threshold_is_absolute_as_in_jax(scores, port_lr, torch_lr):
    s = Scheduler("plateau", 1.0, gamma=0.1, lr_decay_iters=1)
    j = jax_optim.Scheduler("plateau", 1.0, gamma=0.1, lr_decay_iters=1)
    for x in scores:
        got, want = s.plateau_step(x), j.plateau_step(x)
        assert got == want
    assert got == pytest.approx(port_lr)
    assert _torch_plateau(scores) == pytest.approx(torch_lr)


@pytest.mark.parametrize("policy", ["lambda", "step", "plateau", "none",
                                    None])
def test_schedules_match_jax(policy):
    kw = dict(niter=3, niter_decay=5, gamma=0.5, lr_decay_iters=2)
    s, j = Scheduler(policy, 0.1, **kw), jax_optim.Scheduler(policy, 0.1, **kw)
    scores = np.random.default_rng(0).uniform(0, 2, 12)
    for e, x in enumerate(scores):
        assert s.epoch_lr(e) == j.epoch_lr(e)
        assert s.plateau_step(x) == j.plateau_step(x)
    with pytest.raises(NotImplementedError):
        Scheduler("cosine", 0.1)


# ----------------------------------------------------------------------
# One JAX Trainer and one port Trainer on the same data
# ----------------------------------------------------------------------

def _cfg(mod, save_path):
    return mod(resize=RESIZE, batch_size=4, val_batch_size=2, reg_ls=1.0,
               save_path=save_path, print_freq=1000, num_train=10,
               save_freq=0, nepochs=2, split_percentage=0.2)


def _loaders(pkg_dataset, pkg_loader, root, cfg, **kw):
    def factory(valid_idx):
        return pkg_dataset.LaneDataset(
            "bp", root["image_dir"], root["gt_dir"], valid_idx=valid_idx,
            resize=RESIZE, nclasses=4, flip_on=True,
            lanes_file=root["lanes_file"], line_file=root["line_file"],
            image_dtype="uint8")

    train, valid, valid_idx = pkg_loader.get_loader(
        factory, 10, 4, 2, nworkers=1, flip_on=True, seed=0)
    test = pkg_loader.get_testloader(pkg_dataset.LaneTestSet(
        root["test_label_file"], root["test_dir"], RESIZE), 2, nworkers=1)
    return train, valid, test, valid_idx


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX Trainer: validate and score its seeded weights, then fit 2
    epochs. The port's Trainer on the same data, holding the same
    weights, does the same."""
    base = tmp_path_factory.mktemp("trainer_parity")
    root = make_synthetic_root(str(base / "data"), num_train=10, num_test=2,
                               seed=4)
    out = {"root": root, "base": base}

    jcfg = _cfg(jax_cfg, str(base / "jax")).replace(test_dir=root["test_dir"])
    jt = JaxTrainer(jcfg, use_mesh=False, log_to_file=False, verbose=False)
    tl, vl, test, valid_idx = _loaders(jax_dataset, jax_loader, root, jcfg)
    vs = str(base / "valid_jax.json")
    load_valid_set_file_all(valid_idx, vs, root["image_dir"],
                            root["labels_all_file"])
    labels = read_json_lines(vs)
    variables = jax.device_get(jt.state.variables)
    out["jax_val"] = jt.validate(vl, 0, labels)
    out["jax_acc"] = jax_driver.test_model(
        test, jt.lanenet, variables, jcfg, save_path=str(base / "jax_test"),
        verbose=False)
    out["jax_fit"] = jt.fit(tl, vl, test, labels)
    out["jax_dir"] = jt.save_path
    out["variables"] = variables

    cfg = _cfg(train_sh_config, str(base / "port")).replace(
        test_dir=root["test_dir"])
    pt = driver.Trainer(cfg, log_to_file=False, verbose=False, device="cpu")
    pt.lanenet.load_state_dict(state_dict_from_variables(variables))
    tl, vl, test, _ = _loaders(dataset, loader, root, cfg)
    out["port_val"] = pt.validate(vl, 0, labels)
    out["port_acc"] = test_driver.test_model(
        test, pt.lanenet, cfg, save_path=str(base / "port_test"),
        verbose=False)
    out["port_fit"] = pt.fit(tl, vl, test, labels)
    out["port_dir"] = pt.save_path
    out["cfg"], out["loaders"], out["labels"] = cfg, (tl, vl, test), labels
    return out


def test_validate_and_test_model_match_jax_on_its_weights(run):
    got, want = run["port_val"], run["jax_val"]
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for k in ("acc_line", "acc_horizon"):
        assert got[k] == want[k], k
    assert run["port_acc"] == run["jax_acc"]
    # the same points kept; a kept x may round to the next pixel (the
    # float32 fit's conditioning, tests/test_torch_eval.py)
    a = read_json_lines(os.path.join(run["base"], "port_test",
                                     "test_set_predictions.json"))
    b = read_json_lines(os.path.join(run["base"], "jax_test",
                                     "test_set_predictions.json"))
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        px, py = np.array(x["lanes"]), np.array(y["lanes"])
        np.testing.assert_array_equal(px == -2, py == -2)
        assert np.abs(px - py).max() <= 1


def _file_set(root):
    names = set()
    for d, _, files in os.walk(root):
        for n in files:
            names.add(re.sub(r"model_best_epoch_\d+", "model_best_epoch_E",
                             os.path.relpath(os.path.join(d, n), root)))
    return names


def test_fit_writes_the_jax_file_set(run):
    port, jax_dir = run["port_dir"], run["jax_dir"]
    assert os.path.basename(port) == os.path.basename(jax_dir)
    got, want = _file_set(port), _file_set(jax_dir)
    assert got == want
    for name in ("checkpoint_model_epoch_1.pkl", "first_run.txt",
                 "scalars.jsonl", "validation_set_dst.json",
                 "test_set_predictions.json", "model_best_epoch_E.pkl"):
        assert name in got, name
    assert "checkpoint_model_epoch_0.pkl" not in got
    assert sorted(run["port_fit"]) == sorted(run["jax_fit"])
    assert all(np.isfinite(v) for v in run["port_fit"].values())
    rows = read_json_lines(os.path.join(port, "scalars.jsonl"))
    assert [r["epoch"] for r in rows] == [1, 2]
    assert sorted(rows[0]) == sorted(read_json_lines(
        os.path.join(jax_dir, "scalars.jsonl"))[0])
    assert len(read_json_lines(os.path.join(
        port, "validation_set_dst.json"))) == 2


def test_resume_and_best_checkpoint(run):
    """A fresh Trainer resumes at epoch 3 with the checkpoint's weights bit
    for bit and its best score, trains the third epoch, and the rolling
    checkpoint moves on."""
    cfg = run["cfg"]
    port = run["port_dir"]
    assert checkpoint.latest_checkpoint_epoch(port) == 1
    payload = torch.load(os.path.join(port, "checkpoint_model_epoch_1.pkl"),
                         weights_only=False)
    assert sorted(payload) == ["arch", "best epoch", "epoch", "loss",
                               "state_dict"]
    assert payload["epoch"] == 2 and payload["arch"] == "erfnet"
    best = checkpoint.best_checkpoint_path(port)
    assert re.search(r"model_best_epoch_[01]\.pkl$", best)
    assert payload["best epoch"] == int(best[-5]) + 1

    t = driver.Trainer(cfg.replace(nepochs=3), log_to_file=False,
                       verbose=False, device="cpu")
    assert t.maybe_resume()
    assert t.start_epoch == 2 and t.best_epoch == payload["best epoch"]
    assert t.best_score == payload["loss"]
    assert t.state.step == 4
    for k, v in t.lanenet.state_dict().items():
        assert torch.equal(v, payload["state_dict"]["model"][k]), k
    tl, vl, test = run["loaders"]
    t.fit(tl, vl, test, run["labels"])
    assert checkpoint.latest_checkpoint_epoch(port) == 2
    assert not os.path.exists(os.path.join(port,
                                           "checkpoint_model_epoch_1.pkl"))
    assert t.state.step == 6


def test_empty_validation_repeats_the_train_loss(run, capsys, tmp_path):
    cfg = run["cfg"].replace(save_path=str(tmp_path), clas=False,
                             nepochs=1)
    t = driver.Trainer(cfg, log_to_file=False, verbose=False, device="cpu")
    tl, _, _ = run["loaders"]
    m = t.fit(tl, None)
    assert m["val_loss"] == m["train_loss"]
    assert driver.EMPTY_VALIDATION in capsys.readouterr().out


@pytest.mark.parametrize("kw,said", [
    (dict(num_devices=2), "item 8"),
    (dict(num_slices=2), "item 8"),
    (dict(use_pallas_wls=False), "K12")])
def test_unported_paths_raise(kw, said, tmp_path):
    cfg = train_sh_config(resize=RESIZE, save_path=str(tmp_path), **kw)
    with pytest.raises(NotImplementedError, match=said):
        driver.Trainer(cfg, log_to_file=False, verbose=False, device="cpu")


def test_trainer_refuses_to_fall_back_to_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = train_sh_config(resize=RESIZE, save_path=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.Trainer(cfg, log_to_file=False, verbose=False)
    t = driver.Trainer(cfg.replace(no_cuda=True), log_to_file=False,
                       verbose=False)
    assert t.device.type == "cpu"


# ----------------------------------------------------------------------
# Init schemes
# ----------------------------------------------------------------------

def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_init_fans_match_jax_for_every_kernel(run):
    model = LaneNet(train_sh_config(resize=RESIZE), device="cpu")
    fans = init.kernel_fans(model)
    params = run["variables"]["params"]
    assert len(fans) > 50
    for name, got in fans.items():
        path, kind = _flax_path(name.rsplit(".", 1)[0])
        shape = np.shape(_leaf(params, path)["kernel"])
        assert got == jax_init._fans(shape), name
        m = model.get_submodule(name.rsplit(".", 1)[0])
        assert init.flax_shape(m) == shape, name


def test_init_spreads_match_jax(run):
    """kaiming on the whole model: every leaf of 4096 or more elements has
    the JAX Trainer's std within 5%, biases are 0, BatchNorm scales are
    N(1, 0.02)."""
    model = LaneNet(train_sh_config(resize=RESIZE), device="cpu")
    init.init_weights(model, "kaiming", torch.Generator().manual_seed(0))
    params = run["variables"]["params"]
    large = 0
    for mname, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                          torch.nn.Linear)):
            assert not m.bias.any(), mname
            if m.weight.numel() >= 4096:
                want = np.std(_leaf(params, _flax_path(mname)[0])["kernel"])
                assert m.weight.std().item() == pytest.approx(
                    want, rel=0.05), mname
                large += 1
        elif isinstance(m, torch.nn.BatchNorm2d):
            assert not m.bias.any()
            assert abs(m.weight.mean().item() - 1.0) < 0.02
    assert large > 30


@pytest.mark.parametrize("scheme", init.SCHEMES)
@pytest.mark.parametrize("shape", [(3, 3, 128, 64), (2, 2, 16, 4),
                                   (2048, 128), (1, 1, 128, 128)])
def test_init_schemes_match_jax_spread(scheme, shape):
    got = init.draw_kernel(shape, scheme, torch.Generator().manual_seed(1))
    want = np.asarray(jax_init._init_kernel(jax.random.PRNGKey(1), shape,
                                            scheme))
    assert tuple(got.shape) == shape
    rel = 0.05 if np.prod(shape) >= 4096 else 0.5
    assert got.std().item() == pytest.approx(float(want.std()), rel=rel)
    if scheme == "orthogonal":
        flat = got.reshape(-1, shape[-1]).double()
        small = min(flat.shape)
        gram = flat.T @ flat if flat.shape[0] >= flat.shape[1] else \
            flat @ flat.T
        torch.testing.assert_close(gram, torch.eye(small, dtype=gram.dtype),
                                   atol=1e-5, rtol=0)


def test_transposed_convolution_takes_the_flax_fans():
    """ConvTranspose2d(16, 4, 2, stride=2): the flax layout (2, 2, 16, 4)
    gives fan_in 64 (std 0.177), where torch's own kaiming reads 16."""
    m = torch.nn.ConvTranspose2d(16, 4, 2, stride=2)
    assert init.fans(init.flax_shape(m)) == (64, 16)
    init.init_weights(m, "kaiming", torch.Generator().manual_seed(0))
    assert m.weight.std().item() == pytest.approx((2 / 64) ** 0.5, rel=0.15)


# ----------------------------------------------------------------------
# Panels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("x_cal", [False, True])
def test_weightmap_panels_are_written(tmp_path, x_cal):
    """The panels as one PIL raster: the image, the weight maps and the
    fitted curves stacked, each curve in its lane's colour, and the
    backprojected x coordinates as points when given."""
    from PIL import Image

    from lanedetection_end2end_tpu_torch.train import visualize
    rng = np.random.default_rng(0)
    H, W = RESIZE, 2 * RESIZE
    image = torch.from_numpy(rng.uniform(0, 1, (2, H, W, 3)).astype(
        np.float32))
    wmaps = torch.from_numpy(rng.uniform(0, 1, (2, 4, H, W)).astype(
        np.float32))
    # lane k the vertical line x = 8k + 4
    beta = torch.zeros(2, 4, 4)
    beta[..., 3] = torch.arange(4.0) * 8 + 4
    lanes = torch.from_numpy(rng.uniform(0, W, (2, 4, 56)).astype(
        np.float32))
    xc = torch.full((2, 4, 56), W - 2.0) if x_cal else None
    path = visualize.save_weightmap("valid", wmaps, beta, lanes, image,
                                    str(tmp_path), batch_idx=25, x_cal=xc,
                                    resize=RESIZE)
    assert path == str(tmp_path / "example" / "valid" /
                       "idx-0_batch-25.png")
    with Image.open(path) as im:
        assert im.size == (W, 3 * H)
        panel = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(
        panel[:H], np.round(image[0].numpy() * 255).astype(np.uint8))
    curves = panel[2 * H:]
    for k in range(4):
        assert (curves[:, 8 * k + 4] == visualize._COLOURS[k]).all()
    assert (curves[:, W - 2] != 255).any() == x_cal


def test_pretrain_panel_is_written(tmp_path):
    from PIL import Image

    from lanedetection_end2end_tpu_torch.train import visualize
    rng = np.random.default_rng(1)
    H, W = RESIZE, 2 * RESIZE
    image = torch.from_numpy(rng.uniform(0, 1, (2, H, W, 3)).astype(
        np.float32))
    seg = torch.from_numpy(rng.normal(0, 1, (2, H, W, 5)).astype(np.float32))
    gt = torch.from_numpy(rng.integers(0, 5, (2, H, W)).astype(np.uint8))
    path = visualize.save_pretrain_panel(image, gt, seg, str(tmp_path), 3)
    assert path == str(tmp_path / "example" / "pretrain" / "idx-0_batch-3.png")
    with Image.open(path) as im:
        assert im.size == (W, 3 * H)
