"""The Trainer, the Loader and `main_torch.py` over two gloo ranks on the
CPU, and the device-count rules of the JAX Trainer.

- The Loader: rank p of 2 decodes exactly the contiguous rows p of each
  global batch, bit for bit the JAX Loader's with `process_index=p,
  process_count=2` (tests/test_train.py's multi-process loader test).
- The rules (tests/test_train.py::test_mesh_guardrails): an explicit
  `num_devices` that does not divide the batch raises, an implicit one
  shrinks with JAX's RuntimeWarning; `num_slices` must divide the ranks;
  the CLI asks for no more cards than there are and runs NCCL on them.
- One launch of two ranks fits one epoch, then a second Trainer in each
  rank resumes and fits the next, dropout off: rank 0 alone writes (an
  audit hook in rank 1 records every file it would create, change or
  delete under the run's directory: none), the files are those of one
  process's run, each epoch's metrics are one process's at 1e-4, and the
  resume starts where the first fit ended; after one more epoch with
  dropout on (each rank its own draws) the two ranks hold the same
  weights.
- `main_torch.py --no_cuda true --num_devices 2` trains one epoch over two
  ranks; `--num_devices 3` at batch 8 raises before any file is written.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

import main_torch
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.data import dataset, loader
from lanedetection_end2end_tpu_torch.data.labels import (
    load_valid_set_file_all, read_json_lines)
from lanedetection_end2end_tpu_torch.data.synthetic import make_synthetic_root
from lanedetection_end2end_tpu_torch.parallel import spawn
from lanedetection_end2end_tpu_torch.train import driver
from test_torch_threads import one_torch_thread  # noqa: F401

RESIZE = 32
# the two-rank fit's learning rate: Adam's first steps move every weight by
# about the rate whatever its gradient's size, so at the default 1e-4 the
# order of the ranks' sums alone takes the losses of two steps 2.4e-3
# (train) and 3.8e-3 (validation) from one process's; at 1e-7 they read
# 1.8e-5 and 6.6e-6, under the step tests' 1e-4
FIT_LR = 1e-7
_WRITE_EVENTS = ("os.rename", "os.remove", "os.mkdir", "shutil.copyfile",
                 "os.truncate", "os.chmod")


def _cfg(save_path, root, **kw):
    base = dict(resize=RESIZE, batch_size=4, val_batch_size=2, reg_ls=1.0,
                save_path=save_path, print_freq=1000, num_train=10,
                save_freq=1, nepochs=1, split_percentage=0.2,
                test_dir=root["test_dir"])
    base.update(kw)
    return train_sh_config(**base)


def _loaders(root, rank=0, world=1):
    def factory(valid_idx):
        return dataset.LaneDataset(
            "bp", root["image_dir"], root["gt_dir"], valid_idx=valid_idx,
            resize=RESIZE, nclasses=4, flip_on=True,
            lanes_file=root["lanes_file"], line_file=root["line_file"],
            image_dtype="uint8")

    train, valid, _ = loader.get_loader(factory, 10, 4, 2, nworkers=1,
                                        flip_on=True, seed=0,
                                        process_index=rank,
                                        process_count=world)
    test = loader.get_testloader(dataset.LaneTestSet(
        root["test_label_file"], root["test_dir"], RESIZE), 2, nworkers=1)
    return train, valid, test


def _record_writes(under):
    """Audit hook: every file this process would create, change or delete
    under `under` is appended to the returned list."""
    seen = []

    def hook(event, args):
        if event == "open" and isinstance(args[0], str):
            mode = args[1] or "r"
            if any(c in mode for c in "wax+") and args[0].startswith(under):
                seen.append((event, args[0]))
        elif event in _WRITE_EVENTS and any(
                isinstance(a, str) and a.startswith(under) for a in args):
            seen.append((event, args[0]))

    sys.addaudithook(hook)
    return seen


def _fit_ranks(dp, save_path, root, labels):
    """One epoch, then a resumed Trainer's next epoch, on rank `dp`, with
    dropout off (as the one process's below); then one more epoch with
    dropout on, each rank drawing its own."""
    torch.set_num_threads(1)
    writes = _record_writes(save_path) if dp.rank else []
    cfg = _cfg(save_path, root, num_devices=2, learning_rate=FIT_LR)
    train, valid, test = _loaders(root, dp.rank, dp.world)
    first = driver.Trainer(cfg, log_to_file=True, verbose=True, dp=dp)
    first.generator = None
    last = first.fit(train, valid, test, labels)
    second = driver.Trainer(cfg.replace(nepochs=2), log_to_file=False,
                            verbose=False, dp=dp)
    resumed = second.maybe_resume()
    start = second.start_epoch
    second.generator, dropout = None, second.generator
    last2 = second.fit(train, valid, test, labels)
    second.generator = dropout
    second.train_epoch(train, 1)  # epoch 2 again: its panels' names
    params = torch.cat([p.detach().reshape(-1)
                        for p in second.lanenet.parameters()]).numpy()
    return {"last": last, "last2": last2, "resumed": resumed,
            "start": start, "writes": writes, "params": params,
            "dir": first.save_path}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = tmp_path_factory.mktemp("dp_data")
    return make_synthetic_root(str(base / "data"), num_train=10, num_test=2,
                               seed=4)


@pytest.fixture(scope="module")
def fit(root, tmp_path_factory):
    base = tmp_path_factory.mktemp("dp_fit")
    _, _, valid_idx = loader.get_loader(lambda v: [], 10, 4, 2)
    vs = str(base / "valid.json")
    load_valid_set_file_all(valid_idx, vs, root["image_dir"],
                            root["labels_all_file"])
    labels = read_json_lines(vs)
    ranks_dir = str(base / "ranks")
    ranks = spawn(_fit_ranks, 2, args=(ranks_dir, root, labels))
    stdout = sys.stdout  # the Logger tee
    try:
        one = driver.Trainer(_cfg(str(base / "one"), root,
                                  learning_rate=FIT_LR), log_to_file=True,
                             verbose=False, device="cpu")
        one.generator = None
        train, valid, test = _loaders(root)
        last = one.fit(train, valid, test, labels)
    finally:
        sys.stdout = stdout
    second = driver.Trainer(_cfg(str(base / "one"), root, nepochs=2,
                                 learning_rate=FIT_LR),
                            log_to_file=False, verbose=False, device="cpu")
    second.maybe_resume()
    second.generator = None
    last2 = second.fit(train, valid, test, labels)
    return {"ranks": ranks, "ranks_dir": ranks[0]["dir"],
            "one_dir": one.save_path, "one": {"last": last, "last2": last2}}


def test_two_rank_fit_writes_one_process_files_from_rank_0(fit):
    from test_torch_trainer import _file_set
    r0, r1 = fit["ranks"]
    assert r1["writes"] == []
    assert _file_set(fit["ranks_dir"]) == _file_set(fit["one_dir"])
    rows = read_json_lines(os.path.join(fit["ranks_dir"], "scalars.jsonl"))
    assert [r["epoch"] for r in rows] == [1, 2]
    for r in (r0, r1):
        assert np.isfinite(r["last"]["train_loss"])
        assert 0.0 <= r["last"]["test_acc"] <= 1.0


def test_two_rank_fit_agrees_across_ranks_and_resumes(fit):
    r0, r1 = fit["ranks"]
    np.testing.assert_array_equal(r0["params"], r1["params"])
    for key in ("last", "last2"):   # all but the host's timings
        a, b = ({k: v for k, v in r[key].items() if not k.endswith("_time")}
                for r in (r0, r1))
        assert a == b and "val_loss" in a
    assert r0["resumed"] and r1["resumed"]
    assert r0["start"] == r1["start"] == 1


@pytest.mark.parametrize("key", ["last", "last2"])
def test_two_rank_fit_losses_are_one_process(fit, key):
    """Dropout off, the ranks' train and validation metrics and the test
    accuracy of each epoch are the one process's at the step tests' 1e-4
    (read at most 1.8e-5): a fault of the Trainer both ranks share (a
    rank validating its own rows alone, a loss mean scaled by the ranks)
    shows here."""
    got, want = fit["ranks"][0][key], fit["one"][key]
    keys = sorted(k for k in want if not k.endswith("_time"))
    assert keys == sorted(k for k in got if not k.endswith("_time"))
    assert "val_loss" in keys and "test_acc" in keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


# ----------------------------------------------------------------------
# The Loader's rank rows against JAX's
# ----------------------------------------------------------------------

def test_rank_loaders_decode_jax_rows(root):
    from lanedetection_end2end_tpu.data import dataset as jax_dataset
    from lanedetection_end2end_tpu.data import loader as jax_loader
    from test_torch_native_race import require_jax_native

    require_jax_native()
    kw = dict(valid_idx=[], resize=RESIZE, nclasses=4,
              lanes_file=root["lanes_file"], line_file=root["line_file"])
    ds = dataset.LaneDataset("bp", root["image_dir"], root["gt_dir"], **kw)
    jds = jax_dataset.LaneDataset("bp", root["image_dir"], root["gt_dir"],
                                  **kw)
    full = next(iter(loader.Loader(ds, range(8), 8, shuffle=True, flip=True,
                                   seed=3, nworkers=1)))
    for p in (0, 1):
        got = next(iter(loader.Loader(ds, range(8), 8, shuffle=True,
                                      flip=True, seed=3, nworkers=1,
                                      process_index=p, process_count=2)))
        want = next(iter(jax_loader.Loader(jds, range(8), 8, shuffle=True,
                                           flip=True, seed=3, nworkers=1,
                                           process_index=p,
                                           process_count=2)))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], k)
            np.testing.assert_array_equal(got[k], full[k][4 * p:4 * p + 4])


# ----------------------------------------------------------------------
# Device-count rules
# ----------------------------------------------------------------------

def test_mesh_guardrails(tmp_path, root):
    """As tests/test_train.py::test_mesh_guardrails: an explicit count the
    batch does not divide raises; an implicit one (every device) shrinks
    loudly."""
    with pytest.raises(ValueError, match="does not divide"):
        driver.Trainer(_cfg(str(tmp_path / "a"), root, batch_size=7,
                            num_devices=8), log_to_file=False,
                       verbose=False, device="cpu")
    cfg = _cfg(str(tmp_path / "b"), root, batch_size=7, val_batch_size=7)
    with pytest.warns(RuntimeWarning, match="REDUCED"):
        assert driver.resolve_world(cfg, 8) == 7
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert driver.resolve_world(cfg.replace(batch_size=8,
                                                val_batch_size=8), 8) == 8


@pytest.mark.parametrize("slices,ok", [(2, True), (3, False)])
def test_num_slices_must_divide_the_ranks(root, tmp_path, slices, ok):
    cfg = _cfg(str(tmp_path), root, batch_size=8, val_batch_size=8,
               num_devices=4, num_slices=slices)
    if ok:
        assert driver.resolve_world(cfg, 4) == 4
    else:
        with pytest.raises(ValueError, match="num_slices=3"):
            driver.resolve_world(cfg, 4)


def test_cli_ranks_on_cards(monkeypatch, root, tmp_path):
    """On a machine with 2 cards: 3 asked raise naming the count, 0 takes
    every card with a RuntimeWarning that it does not yet scale (fewer
    where the batch does not divide), an explicit count warns nothing, all
    over NCCL; with --no_cuda, gloo on the CPU, 0 one rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = _cfg(str(tmp_path), root, batch_size=8, val_batch_size=8)
    with pytest.raises(ValueError, match="the 2 this machine has"):
        main_torch.ranks(cfg.replace(num_devices=3))
    with pytest.warns(RuntimeWarning, match="one on each card"):
        assert main_torch.ranks(cfg) == (2, ["cuda:0", "cuda:1"], "nccl")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert main_torch.ranks(cfg.replace(num_devices=2))[0] == 2
        assert main_torch.ranks(cfg.replace(num_devices=1))[0] == 1
    with pytest.warns(RuntimeWarning, match="REDUCED"):
        assert main_torch.ranks(cfg.replace(batch_size=7, val_batch_size=7)
                                )[0] == 1
    assert main_torch.ranks(cfg.replace(no_cuda=True)) == (1, ["cpu"],
                                                           "gloo")
    assert main_torch.ranks(cfg.replace(no_cuda=True, num_devices=2)) == (
        2, ["cpu", "cpu"], "gloo")


# ----------------------------------------------------------------------
# main_torch.py over two ranks
# ----------------------------------------------------------------------

def _argv(save_path, *extra):
    return ("--synthetic 10 --resize 32 --batch_size 4 --val_batch_size 2 "
            "--loss_policy backproject --nclasses 4 --order 3 --clas 1 "
            "--reg_ls 1.0 --print_freq 1000 --save_freq 0 --nworkers 1 "
            f"--save_path {save_path} --no_cuda true --nepochs 1").split() + \
        list(extra)


def test_main_runs_two_ranks_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # the Logger tee
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the ranks' threads
    last = main_torch.main(_argv(tmp_path, "--num_devices", "2"))
    assert np.isfinite(last["train_loss"]) and "test_acc" in last
    cfg = main_torch.parse_args(_argv(tmp_path))[0]
    rows = read_json_lines(os.path.join(str(tmp_path), cfg.save_id,
                                        "scalars.jsonl"))
    assert [r["epoch"] for r in rows] == [1]


def test_main_refuses_three_ranks_at_batch_8(tmp_path):
    with pytest.raises(ValueError, match="does not divide"):
        main_torch.main(_argv(tmp_path, "--num_devices", "3",
                              "--batch_size", "8"))
    assert not os.path.exists(tmp_path / "synthetic_data")
