"""The staged schedule in the port's Trainer against the JAX package's (no
mesh).

The train.sh config with `pretrained=True`, `pretrain_epochs=2`,
`skip_epochs=1`, 3 epochs on the same synthetic data: epoch 1 skip (no
validation), epoch 2 seg (validated with the seg step, scored on the
test set), epoch 3 e2e. With JAX's seeded weights
carried over, the seg validation gives the same loss and rmse; each fit
writes the same files and the same scalars' keys epoch by epoch, and
keeps as best the epoch of highest test accuracy among those scored. The
fits' numbers differ (dropout), so the loop is held by its files, keys
and choices. Bars: validation loss and rmse rtol 1e-4."""

import os
import re

import jax
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.config import train_sh_config as jax_sh
from lanedetection_end2end_tpu.data import dataset as jax_dataset
from lanedetection_end2end_tpu.data import loader as jax_loader
from lanedetection_end2end_tpu.train.driver import Trainer as JaxTrainer
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.data import dataset, loader
from lanedetection_end2end_tpu_torch.data.labels import (
    load_valid_set_file_all, read_json_lines)
from lanedetection_end2end_tpu_torch.data.synthetic import make_synthetic_root
from lanedetection_end2end_tpu_torch.models.port import (
    state_dict_from_variables)
from lanedetection_end2end_tpu_torch.train import driver
from test_torch_trainer import _file_set, _loaders

STAGED = dict(pretrained=True, pretrain_epochs=2, skip_epochs=1)


def _cfg(mod, save_path, root):
    return mod(resize=32, batch_size=4, val_batch_size=2, reg_ls=1.0,
               save_path=save_path, print_freq=1000, num_train=10,
               save_freq=0, nepochs=3, split_percentage=0.2,
               test_dir=root["test_dir"], **STAGED)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    base = tmp_path_factory.mktemp("trainer_staged")
    root = make_synthetic_root(str(base / "data"), num_train=10, num_test=2,
                               seed=8)
    out = {}
    jt = JaxTrainer(_cfg(jax_sh, str(base / "jax"), root), use_mesh=False,
                    log_to_file=False, verbose=False)
    tl, vl, test, valid_idx = _loaders(jax_dataset, jax_loader, root, None)
    vs = str(base / "valid.json")
    load_valid_set_file_all(valid_idx, vs, root["image_dir"],
                            root["labels_all_file"])
    labels = read_json_lines(vs)
    variables = jax.device_get(jt.state.variables)
    out["jax_val"] = jt.validate(vl, 1, labels)
    out["jax_fit"] = jt.fit(tl, vl, test, labels)
    out["jax_dir"] = jt.save_path

    pt = driver.Trainer(_cfg(train_sh_config, str(base / "port"), root),
                        log_to_file=False, verbose=False, device="cpu")
    pt.lanenet.load_state_dict(state_dict_from_variables(variables))
    tl, vl, test, _ = _loaders(dataset, loader, root, None)
    out["port_val"] = pt.validate(vl, 1, labels)
    out["port_fit"] = pt.fit(tl, vl, test, labels)
    out["port_dir"] = pt.save_path
    out["trainer"] = pt
    return out


def test_seg_validation_matches_jax_on_its_weights(run):
    got, want = run["port_val"], run["jax_val"]
    assert sorted(got) == sorted(want) == ["loss", "rmse"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_staged_fit_writes_the_jax_files_and_scalars(run):
    port, jax_dir = run["port_dir"], run["jax_dir"]
    assert _file_set(port) == _file_set(jax_dir)
    rows = read_json_lines(os.path.join(port, "scalars.jsonl"))
    jrows = read_json_lines(os.path.join(jax_dir, "scalars.jsonl"))
    assert [r["epoch"] for r in rows] == [1, 2, 3]
    assert [sorted(r) for r in rows] == [sorted(r) for r in jrows]
    # skip: no validation and no score; seg: the metric rmse; e2e: heads
    assert "val_loss" not in rows[0] and "test_acc" not in rows[0]
    assert "val_rmse" in rows[1] and "test_acc" in rows[1]
    assert "val_loss_line" in rows[2] and "val_rmse" not in rows[2]
    assert all(np.isfinite(v) for r in rows for v in r.values())


@pytest.mark.parametrize("which", ["port", "jax"])
def test_best_model_is_the_highest_test_accuracy(run, which):
    d = run[f"{which}_dir"]
    rows = read_json_lines(os.path.join(d, "scalars.jsonl"))
    accs = [r.get("test_acc", -np.inf) for r in rows]
    best = [f for f in os.listdir(d) if f.startswith("model_best")]
    assert len(best) == 1
    epoch = int(re.search(r"_(\d+)\.pkl$", best[0]).group(1))
    assert epoch == int(np.argmax(accs)) and epoch >= 1
    if which == "port":
        t = run["trainer"]
        assert not t.minimize and t.best_epoch == epoch + 1
        sd = torch.load(os.path.join(d, best[0]),
                        weights_only=False)["state_dict"]["model"]
        assert "net.decoder.output_conv2.weight" in sd
