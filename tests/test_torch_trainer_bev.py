"""The port's Trainer in the BEV profile against the JAX package's (no
mesh) on the same synthetic data, 4 lanes with the heads: with JAX's
seeded weights carried over, `validate` gives the same metrics, the same
fitted-curve records (`validation_set_dst.json`) and the same TuSimple
lines (`ls_result.json`, `write_lsq_results`) and LaneEval score
(`acc_seg`); a 2-epoch `fit` of each writes the same files and scalars,
and each keeps as its best model the epoch of least exact area. The two
fits' numbers differ (dropout draws from different generators), so the
loop is held by its files, its keys and its own choice of best epoch.

Bars: validation loss and exact area rtol 1e-4 (float32 eval graphs,
tests/test_torch_trainer.py), the records' beta per coefficient at 1e-4
of its column's largest value, the written lanes at the same points
within one pixel, accuracies equal."""

import os
import re

import jax
import numpy as np
import pytest

from lanedetection_end2end_tpu.config import bev_defaults as jax_bev
from lanedetection_end2end_tpu.data import dataset as jax_dataset
from lanedetection_end2end_tpu.data import loader as jax_loader
from lanedetection_end2end_tpu.train.driver import Trainer as JaxTrainer
from lanedetection_end2end_tpu_torch.config import bev_defaults
from lanedetection_end2end_tpu_torch.data import dataset, loader
from lanedetection_end2end_tpu_torch.data.labels import (
    load_valid_set_file_all, read_json_lines)
from lanedetection_end2end_tpu_torch.data.synthetic import make_synthetic_root
from lanedetection_end2end_tpu_torch.models.port import (
    state_dict_from_variables)
from lanedetection_end2end_tpu_torch.train import driver
from test_torch_trainer import _file_set
from test_torch_native_race import require_jax_native
from test_torch_threads import one_torch_thread  # noqa: F401

RESIZE = 32


def _cfg(mod, save_path, **kw):
    return mod(resize=RESIZE, batch_size=4, val_batch_size=2, reg_ls=1.0,
               save_path=save_path, print_freq=1000, num_train=10,
               save_freq=0, nepochs=2, split_percentage=0.2, nclasses=4,
               clas=True, **kw)


def _loaders(pkg_dataset, pkg_loader, root):
    def factory(valid_idx):
        return pkg_dataset.LaneDataset(
            "bev", root["image_dir"], root["gt_dir"], valid_idx=valid_idx,
            resize=RESIZE, nclasses=4, flip_on=False,
            curves_file=root["curves_file"], line_file=root["line_file"],
            image_dtype="uint8")

    return pkg_loader.get_loader(factory, 10, 4, 2, nworkers=1,
                                 flip_on=False, seed=0)


def _written(save_path):
    return {n: read_json_lines(os.path.join(save_path, n))
            for n in ("validation_set_dst.json", "ls_result.json")}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    require_jax_native()
    base = tmp_path_factory.mktemp("trainer_bev")
    root = make_synthetic_root(str(base / "data"), num_train=10, num_test=2,
                               seed=6)
    out = {}
    jt = JaxTrainer(_cfg(jax_bev, str(base / "jax")), use_mesh=False,
                    log_to_file=False, verbose=False)
    tl, vl, valid_idx = _loaders(jax_dataset, jax_loader, root)
    vs = str(base / "valid.json")
    load_valid_set_file_all(valid_idx, vs, root["image_dir"],
                            root["curves_file"])
    labels = read_json_lines(vs)
    variables = jax.device_get(jt.state.variables)
    out["jax_val"] = jt.validate(vl, 0, labels)
    out["jax_files"] = _written(jt.save_path)
    out["jax_fit"] = jt.fit(tl, vl, None, labels)
    out["jax_dir"] = jt.save_path

    pt = driver.Trainer(_cfg(bev_defaults, str(base / "port")),
                        log_to_file=False, verbose=False, device="cpu")
    pt.lanenet.load_state_dict(state_dict_from_variables(variables,
                                                         profile="bev"))
    tl, vl, _ = _loaders(dataset, loader, root)
    out["port_val"] = pt.validate(vl, 0, labels)
    out["port_files"] = _written(pt.save_path)
    out["port_fit"] = pt.fit(tl, vl, None, labels)
    out["port_dir"] = pt.save_path
    out["trainer"] = pt
    return out


def test_validate_matches_jax_on_its_weights(run):
    got, want = run["port_val"], run["jax_val"]
    assert sorted(got) == sorted(want)
    assert "exact_area" in got and "acc_seg" in got
    for k in ("loss", "exact_area", "loss_line", "loss_horizon"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for k in ("acc_line", "acc_horizon", "acc_seg"):
        assert got[k] == want[k], k


def test_validation_records_and_lsq_lines_match_jax(run):
    got, want = run["port_files"], run["jax_files"]
    a, b = got["validation_set_dst.json"], want["validation_set_dst.json"]
    assert len(a) == len(b) == 2
    pa, pb = (np.array([r["params"] for r in x]) for x in (a, b))
    assert pa.shape == (2, 4, 3)
    diff = np.abs(pa - pb) / np.abs(pb).max(axis=(0, 1))
    assert diff.max() <= 1e-4, diff.max(axis=(0, 1))
    for x, y in zip(a, b):
        assert x["line_id"] == y["line_id"]
        assert {k for k in x} == {k for k in y}
    for x, y in zip(got["ls_result.json"], want["ls_result.json"]):
        lx, ly = np.array(x["lanes"]), np.array(y["lanes"])
        np.testing.assert_array_equal(lx == -2, ly == -2)
        assert np.abs(lx - ly).max() <= 1


def test_fit_writes_the_jax_files_and_scalars(run):
    port, jax_dir = run["port_dir"], run["jax_dir"]
    assert os.path.basename(port) == os.path.basename(jax_dir)
    assert _file_set(port) == _file_set(jax_dir)
    assert sorted(run["port_fit"]) == sorted(run["jax_fit"])
    assert all(np.isfinite(v) for v in run["port_fit"].values())
    rows = read_json_lines(os.path.join(port, "scalars.jsonl"))
    jrows = read_json_lines(os.path.join(jax_dir, "scalars.jsonl"))
    assert [r["epoch"] for r in rows] == [1, 2]
    assert [sorted(r) for r in rows] == [sorted(r) for r in jrows]
    assert "val_exact_area" in rows[0] and "val_acc_seg" in rows[0]


@pytest.mark.parametrize("which", ["port", "jax"])
def test_best_model_is_the_least_exact_area(run, which):
    """Both Trainers keep the epoch of least validation exact area (the
    first of equals), as the BEV reference does."""
    d = run[f"{which}_dir"]
    rows = read_json_lines(os.path.join(d, "scalars.jsonl"))
    areas = [r["val_exact_area"] for r in rows]
    best = [f for f in os.listdir(d) if f.startswith("model_best")]
    assert len(best) == 1
    epoch = int(re.search(r"_(\d+)\.pkl$", best[0]).group(1))
    assert epoch == int(np.argmin(areas))
    if which == "port":
        t = run["trainer"]
        assert t.minimize and t.best_epoch == epoch + 1
        assert t.best_score == pytest.approx(min(areas))
