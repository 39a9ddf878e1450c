#!/usr/bin/env python
"""Training and evaluation CLI of the PyTorch port, on one card or N.

The counterpart of `main.py`, with the same flags (the reference CLI of
`lanedetection_end2end_tpu_torch/config.py::build_parser`, plus
`--synthetic N` and `--test_only`); it imports nothing of the JAX
package. Both profiles train, through the staged schedule where asked:

  python main_torch.py --loss_policy backproject --nclasses 4 --order 3 \\
      --clas 1 --pretrained false --mask_percentage 0.20 --flip_on 1 \\
      --image_dir <imgs> --gt_dir <gt> --json_file <Labels/...json>
  python main_torch.py --profile bev --image_dir <imgs> --gt_dir <gt> \\
      --json_file <Labels/Curve_parameters.json>
  python main_torch.py ... --pretrained true --pretrain_epochs 20 \\
      --skip_epochs 10          # skip, then seg, then e2e epochs
  python main_torch.py ... --end_to_end false   # seg epochs only

  --synthetic N   write an N-image synthetic TuSimple-format dataset under
                  save_path (the port's `data/synthetic.py`, the same files
                  as the JAX package's from the same seed) and train on it;
                  no --image_dir / --gt_dir needed.
  --test_only     load the best checkpoint and run only test-set inference
                  and TuSimple LaneEval scoring; needs the 'bp' profile,
                  --clas 1 and a test set.
  --evaluate      load the best checkpoint, validate, and score the test
                  set ('bp' profile).
  (otherwise)     resume from the run directory's latest checkpoint, if
                  any, and train to --nepochs.

It runs on the card; `--no_cuda true` runs it on the CPU, and without a
card and without that flag it raises. `--compute_dtype bfloat16` runs
every phase's graph in bf16 (the parameters, their gradients and adam's
state stay float32); `--use_pallas_wls false` takes a general
homography's fit moments from K12's plain version.

  --num_devices N  N ranks of data parallelism, one process each, the
                  global batch split over them (`--batch_size` and the
                  validation batch must divide by N): on the card, NCCL
                  with a card per rank (N above the cards present raises);
                  with `--no_cuda true`, N gloo ranks on the CPU. 0 (the
                  default) uses every card, fewer where the batch does not
                  divide (a RuntimeWarning says so); on the CPU one rank.
                  `--num_slices S` must divide the ranks. Two ranks or more
                  do not yet train faster than one card (PERF.md, "Data
                  parallelism"): on a machine with several cards the
                  default warns, and `--num_devices 1` trains on one.
"""

from __future__ import annotations

import os
import sys
import warnings

import torch
import torch.distributed as dist

from lanedetection_end2end_tpu_torch.config import (
    build_parser, config_from_args)
from lanedetection_end2end_tpu_torch.data.dataset import (
    LaneDataset, LaneTestSet)
from lanedetection_end2end_tpu_torch.data.labels import (
    load_valid_set_file_all, read_json_lines)
from lanedetection_end2end_tpu_torch.data.loader import (
    get_loader, get_testloader)
from lanedetection_end2end_tpu_torch.data.synthetic import make_synthetic_root
from lanedetection_end2end_tpu_torch.parallel.launch import spawn
from lanedetection_end2end_tpu_torch.train.checkpoint import (
    best_checkpoint_path)
from lanedetection_end2end_tpu_torch.train.driver import (
    Trainer, resolve_world)


def parse_args(argv=None):
    """-> (LaneConfig, synthetic N, test_only) from the command line."""
    profile = "bp"
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--profile" in argv:
        profile = argv[argv.index("--profile") + 1]
    parser = build_parser(profile)
    parser.add_argument("--synthetic", type=int, default=0,
                        help="generate an N-image synthetic dataset and "
                             "train on it")
    parser.add_argument("--test_only", action="store_true",
                        help="best checkpoint -> test-set inference + "
                             "LaneEval only")
    ns, _ = parser.parse_known_args(argv)
    synthetic, test_only = ns.synthetic, ns.test_only
    argv = [a for i, a in enumerate(argv)
            if a not in ("--synthetic", "--test_only")
            and (i == 0 or argv[i - 1] != "--synthetic")]
    cfg = config_from_args(argv, profile)
    return cfg, synthetic, test_only


def ranks(cfg):
    """-> (world, devices, backend) for the config: on the card one card
    a rank over NCCL, `num_devices` 0 every card (JAX's rules,
    `resolve_world`), more than the cards present a ValueError, and a
    RuntimeWarning where `num_devices` 0 takes more than one card; with
    `no_cuda` gloo ranks on the CPU, `num_devices` 0 one."""
    if cfg.no_cuda:
        world = resolve_world(cfg, max(cfg.num_devices, 1))
        return world, ["cpu"] * world, "gloo"
    cfg.torch_device()  # no card: RuntimeError
    count = torch.cuda.device_count()
    if cfg.num_devices > count:
        raise ValueError(f"--num_devices {cfg.num_devices} asks for more "
                         f"cards than the {count} this machine has")
    world = resolve_world(cfg, count)
    if world > 1 and not cfg.num_devices:
        warnings.warn(
            f"--num_devices 0 starts {world} ranks, one on each card; data "
            "parallelism does not yet train faster than one card (PERF.md, "
            "\"Data parallelism\"). Pass --num_devices 1 to train on one "
            "card.", RuntimeWarning, stacklevel=2)
    return world, [f"cuda:{r}" for r in range(world)], "nccl"


def main(argv=None):
    cfg, synthetic, test_only = parse_args(argv)
    # no card without --no_cuda, and a device count the batch or the
    # machine does not allow, raise before any data is written
    world, devices, backend = ranks(cfg)
    cfg, labels_dir = data_config(cfg, synthetic)
    if world == 1:
        return run(None, cfg, labels_dir, test_only)
    return spawn(run, world, backend, devices,
                 args=(cfg, labels_dir, test_only))[0]


def data_config(cfg, synthetic: int = 0):
    """-> (cfg, labels_dir): with `synthetic` N, an N-image synthetic
    dataset under save_path (written once) and the config pointed at it;
    SystemExit without image and gt directories."""
    if synthetic:
        synth_root = os.path.join(cfg.save_path, "synthetic_data")
        if not os.path.isdir(os.path.join(synth_root, "images")):
            print(f"Generating {synthetic}-image synthetic dataset under "
                  f"{synth_root} ...")
            make_synthetic_root(synth_root, num_train=synthetic,
                                num_test=max(2, synthetic // 8),
                                seed=cfg.seed)
        labels_dir = os.path.join(synth_root, "Labels")
        cfg = cfg.replace(image_dir=os.path.join(synth_root, "images"),
                          gt_dir=os.path.join(synth_root, "ground_truth"),
                          json_file=os.path.join(labels_dir,
                                                 "Curve_parameters.json"),
                          test_dir=os.path.join(synth_root, "test_set"),
                          num_train=min(cfg.num_train, synthetic))
    else:
        labels_dir = os.path.dirname(cfg.json_file) or "Labels"
    if not cfg.image_dir or not cfg.gt_dir:
        raise SystemExit("--image_dir and --gt_dir are required "
                         "(or use --synthetic N)")
    return cfg, labels_dir


def run(dp, cfg, labels_dir: str, test_only: bool):
    """Train, test or evaluate as the flags say, in one process or as rank
    `dp` of N (a `parallel/mesh.py::DataParallel`): every rank loads its
    rows of each batch, rank 0 alone writes and prints. Returns the last
    epoch's metrics, the test accuracy or the evaluation's metrics."""
    trainer = Trainer(cfg, log_to_file=not cfg.test_mode, dp=dp)
    main_rank = trainer.is_main
    say = print if main_rank else (lambda *a, **k: None)
    group = trainer.group
    say("=" * 40 + f"\nArgs:{cfg}\n" + "=" * 40)
    say(f"device: {trainer.device}"
        + (f" (rank 0 of {dp.world}, {dp.backend})" if dp else ""))

    lanes_file = os.path.join(labels_dir, "lanes_ordered.json")
    line_file = os.path.join(labels_dir, "label_new.json")
    # the validation gt records: BEV its curve file's, BP the TuSimple ones
    bev = cfg.profile == "bev"
    labels_all = (cfg.json_file if bev
                  else os.path.join(labels_dir, "label_data_all.json"))
    line_file = line_file if os.path.exists(line_file) else None

    def dataset_factory(valid_idx):
        return LaneDataset(
            cfg.profile, cfg.image_dir, cfg.gt_dir, valid_idx=valid_idx,
            resize=cfg.resize, nclasses=cfg.nclasses, flip_on=cfg.flip_on,
            curves_file=cfg.json_file if bev else None,
            lanes_file=None if bev else lanes_file, line_file=line_file,
            image_dtype="uint8")

    train_loader, valid_loader, valid_idx = get_loader(
        dataset_factory, cfg.num_train, cfg.batch_size,
        cfg.effective_val_batch_size, shuffle=True, nworkers=cfg.nworkers,
        flip_on=cfg.flip_on, split_percentage=cfg.split_percentage,
        seed=cfg.seed, process_index=dp.rank if dp else 0,
        process_count=dp.world if dp else 1)

    # the TuSimple test set is scored in the BP profile (its projections
    # and its line head's presence logits), on rank 0 alone; the BEV
    # profile validates only
    test_loader = None
    if cfg.clas and cfg.test_dir and not bev:
        test_label = os.path.join(cfg.test_dir, "test_label.json")
        if os.path.exists(test_label):
            test_loader = get_testloader(
                LaneTestSet(test_label, cfg.test_dir, cfg.resize),
                cfg.effective_val_batch_size, cfg.nworkers)

    # the validation images' gt records, for the fitted-curve records
    valid_set_labels = None
    if cfg.clas and os.path.exists(labels_all):
        validation_set_path = os.path.join(trainer.save_path,
                                           "validation_set.json")
        if main_rank:
            load_valid_set_file_all(valid_idx, validation_set_path,
                                    cfg.image_dir, labels_all)
        if group is not None:
            dist.barrier(group=group)
        valid_set_labels = read_json_lines(validation_set_path)

    if test_only or cfg.evaluate:
        best = best_checkpoint_path(trainer.save_path)
        if best is None:
            raise SystemExit(f"no best checkpoint under {trainer.save_path}")
        say(f"=> loading checkpoint '{best}'")
        trainer.load(best)

    if test_only:
        if test_loader is None:
            raise SystemExit("--test_only needs --clas 1 and a --test_dir "
                             "containing test_label.json")
        acc = trainer.test_score(test_loader)
        say(f"===> TuSimple test accuracy: {acc:.8f}")
        return {"acc": acc}

    if cfg.evaluate:
        metrics = trainer.validate(valid_loader, epoch=cfg.nepochs,
                                   valid_set_labels=valid_set_labels)
        say({k: float(v) for k, v in metrics.items()})
        if test_loader is not None:
            acc = trainer.test_score(test_loader)
            say(f"===> TuSimple test accuracy: {acc:.8f}")
            metrics["test_acc"] = acc
        return metrics

    trainer.maybe_resume()
    return trainer.fit(train_loader, valid_loader, test_loader,
                       valid_set_labels)


if __name__ == "__main__":
    main()
