"""`main_torch.py` on the CPU (`--no_cuda true`) through the staged
schedule and in the BEV profile: a BP run with `--pretrained true
--pretrain_epochs 2 --skip_epochs 1`, one epoch a call (skip, then seg,
then e2e, each call resuming from the last checkpoint bit for bit), and
a 2-epoch BEV run with its four lanes and heads, then `--evaluate` on its
best checkpoint."""

import os
import re
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import main_torch
from lanedetection_end2end_tpu_torch.data.labels import read_json_lines
from lanedetection_end2end_tpu_torch.train import checkpoint
from test_torch_threads import one_torch_thread  # noqa: F401


def _argv(save_path, *extra):
    return ("--synthetic 10 --resize 32 --batch_size 4 --val_batch_size 2 "
            "--print_freq 1000 --save_freq 2 --nworkers 2 --reg_ls 1.0 "
            f"--save_path {save_path} --no_cuda true").split() + list(extra)


def test_main_runs_the_staged_schedule_and_resumes_on_the_cpu(tmp_path,
                                                              monkeypatch):
    """skip, then seg (a resume at epoch 2), then e2e (a resume at epoch
    3 that starts from the seg epoch's checkpoint bit for bit, whose
    model holds the pretraining head)."""
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # the Logger tee
    flags = ("--loss_policy backproject --nclasses 4 --order 3 --clas 1 "
             "--pretrained true --pretrain_epochs 2 --skip_epochs 1").split()
    cfg = main_torch.parse_args(_argv(tmp_path, *flags))[0]
    run_dir = os.path.join(str(tmp_path), cfg.save_id)
    for epoch in (1, 2, 3):
        with chip_smoke.watch_resume() as resumed:
            main_torch.main(_argv(tmp_path, *flags, "--nepochs", str(epoch)))
        assert resumed == ({} if epoch == 1 else
                           {"start": epoch - 1, "equal": True})
        if epoch == 2:
            sd = torch.load(checkpoint._ckpt_path(run_dir, 1),
                            weights_only=False)["state_dict"]["model"]
            assert "net.decoder.output_conv2.weight" in sd
    rows = read_json_lines(os.path.join(run_dir, "scalars.jsonl"))
    assert [r["epoch"] for r in rows] == [1, 2, 3]
    assert [("val_loss" in r) for r in rows] == [False, True, True]
    assert os.path.exists(os.path.join(run_dir, "example", "pretrain",
                                       "idx-0_batch-2.png"))


def test_main_runs_the_bev_profile_and_evaluates_on_the_cpu(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    flags = ["--profile", "bev", "--nclasses", "4", "--clas", "1"]
    last = main_torch.main(_argv(tmp_path, *flags, "--nepochs", "2"))
    assert np.isfinite(last["val_exact_area"]) and "val_acc_seg" in last
    cfg = main_torch.parse_args(_argv(tmp_path, *flags))[0]
    run_dir = os.path.join(str(tmp_path), cfg.save_id)
    assert os.path.exists(os.path.join(run_dir, "ls_result.json"))
    rows = read_json_lines(os.path.join(run_dir, "scalars.jsonl"))
    best = checkpoint.best_checkpoint_path(run_dir)
    epoch = int(re.search(r"_(\d+)\.pkl$", best).group(1))
    out = main_torch.main(_argv(tmp_path, *flags, "--nepochs", "2",
                                "--evaluate"))
    # the best checkpoint's validation reproduces its epoch's record
    assert out["exact_area"] == pytest.approx(
        rows[epoch]["val_exact_area"], rel=1e-6)
    assert "test_acc" not in out  # the test set is scored in 'bp' only
