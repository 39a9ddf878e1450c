"""The port's command line against the JAX package's: `config_from_args`
and `main_torch.parse_args` read the same command lines to the same
fields, and `main_torch.main` runs the train.sh path on the CPU when
asked (`--no_cuda true`): a 2-epoch run on a synthetic dataset, a resume
to 3 epochs, `--test_only` and `--evaluate`. Without a card and without
that flag it raises."""

import dataclasses
import os

import pytest
import torch

import main as jax_main
import main_torch
from lanedetection_end2end_tpu.config import config_from_args as jax_args
from lanedetection_end2end_tpu_torch.config import (
    build_parser, config_from_args)
from lanedetection_end2end_tpu_torch.data.labels import read_json_lines
from lanedetection_end2end_tpu_torch.train.driver import Trainer
from test_torch_threads import one_torch_thread  # noqa: F401

TRAIN_SH = ("--loss_policy backproject --save_freq 100 --weight_init xavier "
            "--use_cholesky 0 --split_percentage 0.1 --activation_layer square "
            "--pretrained false --pretrain_epochs 25 --skip_epochs 25 "
            "--nclasses 4 --mask_percentage 0.20 --order 3 --clas 1 "
            "--nepochs 400")


def _same_fields(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("argv,profile", [
    (TRAIN_SH, "bp"),
    ("--end_to_end True --nclasses 4 --clas 1 --order 2 --profile bev", "bev"),
    ("--val_batch_size 4 --lr_policy plateau --gamma 0.5 --list 1 2 3 "
     "--no_ortho --flip_on 1 --compute_dtype bfloat16", "bp"),
    ("", "bp")])
def test_config_from_args_matches_jax(argv, profile):
    _same_fields(config_from_args(argv.split(), profile),
                 jax_args(argv.split(), profile))


def test_train_sh_line_reads_as_the_reference_says():
    cfg = config_from_args(TRAIN_SH.split(), profile="bp")
    assert cfg.loss_policy == "backproject" and cfg.weight_init == "xavier"
    assert cfg.nclasses == 4 and cfg.order == 3 and cfg.clas
    assert cfg.mask_percentage == pytest.approx(0.20)
    assert not cfg.pretrained and cfg.nepochs == 400
    assert cfg.save_id == jax_args(TRAIN_SH.split(), "bp").save_id


@pytest.mark.parametrize("argv", [
    "--profile bp --synthetic 8 --test_only --nclasses 4 --clas 1 --order 3",
    "--profile bp --image_dir /x --gt_dir /y",
    "--synthetic 12 --evaluate --resize 64"])
def test_parse_args_matches_main(argv):
    got = main_torch.parse_args(argv.split())
    want = jax_main.parse_args(argv.split())
    _same_fields(got[0], want[0])
    assert got[1:] == want[1:]


def test_parse_args_strips_framework_flags():
    cfg, synthetic, test_only = main_torch.parse_args(
        "--profile bp --synthetic 8 --test_only --nclasses 4 --clas 1 "
        "--order 3".split())
    assert synthetic == 8 and test_only
    assert cfg.nclasses == 4 and cfg.clas and cfg.order == 3
    cfg, synthetic, test_only = main_torch.parse_args(
        "--profile bp --image_dir /x --gt_dir /y".split())
    assert synthetic == 0 and not test_only


@pytest.mark.parametrize("flag,want", [(["--no_cuda", "true"], True),
                                       (["--no_cuda"], True),
                                       (["--no_cuda", "0"], False),
                                       ([], False)])
def test_no_cuda_takes_a_value_or_stands_alone(flag, want):
    assert build_parser().parse_args(flag).no_cuda is want


def _argv(save_path, *extra):
    return ("--synthetic 10 --resize 32 --batch_size 4 --val_batch_size 2 "
            "--loss_policy backproject --nclasses 4 --order 3 --clas 1 "
            "--mask_percentage 0.20 --flip_on 1 --reg_ls 1.0 "
            "--print_freq 1000 --save_freq 2 --nworkers 2 "
            f"--save_path {save_path} --no_cuda true").split() + list(extra)


def test_main_refuses_to_run_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(tmp_path) if a not in ("--no_cuda", "true")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_torch.main(argv + ["--nepochs", "1"])
    assert not os.path.exists(tmp_path / "synthetic_data")


@pytest.mark.parametrize("extra,error,said", [
    # the ids keep the cases' names from when more than one device was
    # refused (ROADMAP Queue 1 item 8); now a device count the batch does
    # not divide, and slices that do not divide the ranks, are refused,
    # as JAX refuses them
    pytest.param(["--num_devices", "3"], ValueError, "does not divide",
                 id="extra0-item 8"),
    pytest.param(["--num_slices", "2"], ValueError, "num_slices=2",
                 id="extra1-item 8")])
def test_main_refuses_unported_paths(tmp_path, extra, error, said):
    with pytest.raises(error, match=said):
        main_torch.main(_argv(tmp_path, "--nepochs", "1", *extra))
    assert not os.path.exists(tmp_path / "synthetic_data")


@pytest.mark.parametrize("extra,field,value", [
    (["--learn_homography", "true"], "learn_homography", True),
    (["--packed_train", "false"], "packed_train", False)])
def test_main_takes_the_learned_homography_and_the_plain_graph(
        tmp_path, extra, field, value):
    """Both flags reach the config under JAX's spelling, and nothing
    refuses them any more (the runs are in
    tests/test_torch_learned_homography.py)."""
    cfg = main_torch.parse_args(_argv(tmp_path, *extra))[0]
    assert getattr(cfg, field) is value
    assert getattr(jax_args(list(extra)), field) is value
    Trainer(cfg, log_to_file=False, verbose=False)


def test_main_trains_with_use_pallas_wls_false(tmp_path, monkeypatch):
    """`--use_pallas_wls false` (JAX's XLA moments; the port's plain
    moments) trains an epoch: the flag reaches the Trainer's fitter, which
    stays separable on the shipped homography and fits from row sums."""
    import sys
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # the Logger tee
    fitters = []
    init = Trainer.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        fitters.append(self.lanenet.fitter)

    monkeypatch.setattr(Trainer, "__init__", spy)
    last = main_torch.main(_argv(tmp_path, "--nepochs", "1",
                                 "--use_pallas_wls", "false"))
    assert torch.isfinite(torch.tensor(last["train_loss"]))
    assert [(f.use_pallas, f.separable) for f in fitters] == [(False, True)]


def test_main_trains_resumes_tests_and_evaluates_on_the_cpu(tmp_path,
                                                            monkeypatch):
    import sys
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # the Logger tee
    last = main_torch.main(_argv(tmp_path, "--nepochs", "2"))
    assert torch.isfinite(torch.tensor(last["train_loss"]))
    cfg = main_torch.parse_args(_argv(tmp_path))[0]
    run_dir = os.path.join(str(tmp_path), cfg.save_id)
    assert os.path.exists(os.path.join(run_dir, "log_train_start_0.txt"))
    rows = read_json_lines(os.path.join(run_dir, "scalars.jsonl"))
    assert [r["epoch"] for r in rows] == [1, 2]

    main_torch.main(_argv(tmp_path, "--nepochs", "3"))
    rows = read_json_lines(os.path.join(run_dir, "scalars.jsonl"))
    assert [r["epoch"] for r in rows] == [1, 2, 3]
    assert os.path.exists(os.path.join(run_dir,
                                       "checkpoint_model_epoch_2.pkl"))

    # --test_only on the best checkpoint reproduces that epoch's accuracy
    best = [f for f in os.listdir(run_dir) if f.startswith("model_best")]
    assert len(best) == 1
    epoch = int(best[0].split("_")[-1].split(".")[0])
    out = main_torch.main(_argv(tmp_path, "--nepochs", "3", "--test_only"))
    assert out["acc"] == rows[epoch]["test_acc"]

    out = main_torch.main(_argv(tmp_path, "--nepochs", "3", "--evaluate"))
    assert out["test_acc"] == rows[epoch]["test_acc"]
    assert torch.isfinite(torch.tensor(out["loss"]))
