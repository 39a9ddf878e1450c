"""Training driver: the epoch loop as one reusable Trainer.

Counterpart of `lanedetection_end2end_tpu/train/driver.py::Trainer`, for
both profiles and the staged schedule, on one device or on N ranks of a
data-parallel world (one process and one card each, `parallel/`):

- the phase of each epoch from `cfg.phase_for_epoch` (with `pretrained`:
  'skip' epochs in the BP profile, then 'seg' up to `pretrain_epochs`,
  then 'e2e'; with `end_to_end` off every epoch is 'seg'); a train step
  and an eval step per phase, made once and held as opaque callables
  (`train_step_for`, `eval_step_for`): e2e on the training backbone in
  `cfg.compute_dtype` on the default kernel path (`fused_blocks=True`,
  `fused_maps=True`: K6-K10 on a card), skip and seg on the plain graph
  in the same dtype;
- per-epoch validation with metric meters (none in a skip epoch; the
  seg step validates), the fitted-curve records of every validation
  image (`validation_set_dst.json`) and, in the BEV profile with `clas`
  and 4 lanes, their TuSimple lines (`write_lsq_results`) scored by
  LaneEval (`acc_seg`); in the BP profile with `val_laneeval`, LaneEval
  on the validation split;
- the epoch score: BEV the validation `exact_area` (minimized); BP the
  TuSimple test accuracy (maximized) when `clas` and a test set are
  given, else the validation loss (minimized); it drives the best model
  and the plateau schedule;
- lambda and step schedules at an epoch's start, plateau at its end;
- rolling and best checkpoints with the `first_run.txt` marker, resume;
- `scalars.jsonl` (one line an epoch), the Logger tee, the weight-map
  panels (a skip epoch's: input, gt and argmax) every `save_freq`
  training batches and every 25 validation batches.

When no validation batch runs, the validation loss repeats the epoch's
train loss, as the JAX Trainer does, and that value then picks the best
model and drives the plateau schedule; the Trainer prints a notice that
the validation set was empty. `packed_train` False trains the e2e
epochs on `LaneNet.forward` (`train/steps.py`); the learned homography
trains them on the packed path like the rest, with the homography head
in the checkpoints. `use_pallas_wls` reaches
the LaneNet's fitter (`models/lanenet.py::make_fitter`); both shipped
homographies are separable, so it changes nothing there, as in JAX.

Over N ranks (`dp=`, a `parallel/mesh.py::DataParallel`; `main_torch.py
--num_devices N` starts them), each rank holds the same weights (rank 0's,
broadcast after the init and after a resume), loads its rows of each
global batch and steps with the others (`train/steps.py`, `group=`).
Every number that picks the best model or steps the plateau schedule is
the same on every rank: the steps' metrics are averaged over the ranks,
and the test-set score, computed on rank 0 alone as JAX's unsharded
`test_model` is, is broadcast. Rank 0 alone writes: the Logger,
`scalars.jsonl`, the checkpoints, the panels, `validation_set_dst.json`,
`ls_result.json` and the LaneEval files. The world's size follows JAX's
rules (`resolve_world`).
"""

from __future__ import annotations

import json
import os
import sys
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from lanedetection_end2end_tpu_torch.config import LaneConfig
from lanedetection_end2end_tpu_torch.data.labels import write_json_lines
from lanedetection_end2end_tpu_torch.data.loader import DevicePrefetcher
from lanedetection_end2end_tpu_torch.device import resolve_device
from lanedetection_end2end_tpu_torch.eval.lane_eval import LaneEval
from lanedetection_end2end_tpu_torch.eval.projections import Projections
from lanedetection_end2end_tpu_torch.eval.results import write_lsq_results
from lanedetection_end2end_tpu_torch.eval.test_driver import (
    make_infer_fn, test_model)
from lanedetection_end2end_tpu_torch.models.init import init_weights
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.parallel.collectives import gather_rows
from lanedetection_end2end_tpu_torch.parallel.mesh import (
    check_slices, rank_seed, replicate)
from lanedetection_end2end_tpu_torch.train.checkpoint import (
    _ckpt_path, latest_checkpoint_epoch, load_checkpoint, save_checkpoint)
from lanedetection_end2end_tpu_torch.train.optim import (
    Scheduler, define_optim, get_lr, set_lr)
from lanedetection_end2end_tpu_torch.train.state import TrainState
from lanedetection_end2end_tpu_torch.train.steps import (
    make_eval_step, make_train_step, prepare_batch)
from lanedetection_end2end_tpu_torch.train.visualize import (
    save_pretrain_panel, save_weightmap)
from lanedetection_end2end_tpu_torch.utils import (
    AverageMeter, Logger, mkdir_if_missing)

EMPTY_VALIDATION = ("notice: the validation set is empty; val_loss repeats "
                    "the epoch's train loss (as the JAX Trainer does) and "
                    "drives the best model and the plateau schedule")


def resolve_world(cfg: LaneConfig, available: int) -> int:
    """The number of ranks, by the JAX Trainer's mesh rules: `num_devices`
    (0: every one of `available`) must divide the train and the
    validation batch; an explicit count that does not raises ValueError,
    an implicit one shrinks to the largest that does, with a
    RuntimeWarning. `num_slices` must divide the result."""
    requested = cfg.num_devices or available
    ndev = requested
    while cfg.batch_size % ndev or cfg.effective_val_batch_size % ndev:
        ndev -= 1
    if ndev != requested:
        if cfg.num_devices:
            # the user asked for exactly this many devices; silently
            # training on fewer would waste the rest
            raise ValueError(
                f"batch_size={cfg.batch_size} (val "
                f"{cfg.effective_val_batch_size}) does not divide over the "
                f"requested num_devices={cfg.num_devices}; pick a divisible "
                "batch size or a different device count")
        warnings.warn(
            f"mesh REDUCED from {requested} to {ndev} devices so the batch "
            f"(train {cfg.batch_size} / val {cfg.effective_val_batch_size}) "
            f"divides over the ranks: {requested - ndev} device(s) will sit "
            "idle. Set a divisible batch_size or pass num_devices "
            "explicitly.", RuntimeWarning, stacklevel=2)
    check_slices(ndev, cfg.num_slices)
    return ndev


def _floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Device scalars -> floats, with one synchronization."""
    if not metrics:
        return {}
    values = torch.stack([v.detach().float().reshape(())
                          for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


class Trainer:
    """Owns the model, the optimizer state and the steps, and runs the
    epoch loop. `device` None: the card unless `cfg.no_cuda`
    (`LaneConfig.torch_device`). `dp`: this process's rank of a
    data-parallel world (its device is the Trainer's); None: one device.
    The world's size must be what `resolve_world` makes of the config:
    ValueError otherwise."""

    def __init__(self, cfg: LaneConfig, log_to_file: bool = True,
                 verbose: bool = True, device=None, dp=None):
        world = dp.world if dp is not None else 1
        want = resolve_world(cfg, world)
        if want != world:
            raise ValueError(
                f"num_devices={cfg.num_devices} asks for {want} ranks but "
                f"this Trainer runs in {world}: start one Trainer per rank "
                "(parallel/launch.py::spawn, as main_torch.py does)")
        self.cfg = cfg
        self.group = dp.group if dp is not None else None
        self.is_main = dp is None or dp.is_main
        self.verbose = verbose and self.is_main
        if dp is not None:
            self.device = dp.device
        else:
            self.device = (cfg.torch_device() if device is None
                           else resolve_device(device))
        self.save_path = os.path.join(cfg.save_path, cfg.save_id)
        if self.is_main:
            mkdir_if_missing(self.save_path)
            for sub in ("train", "valid", "pretrain", "testset"):
                mkdir_if_missing(os.path.join(self.save_path, "example", sub))

        self.lanenet = LaneNet(cfg, device=self.device)
        init_weights(self.lanenet, cfg.weight_init,
                     torch.Generator().manual_seed(cfg.seed))
        replicate(self.lanenet, self.group)
        self.optimizer = define_optim(
            self.lanenet.parameters(), cfg.optimizer, cfg.learning_rate,
            cfg.weight_decay, cfg.clip_grad_norm)
        self.state = TrainState(self.lanenet, self.optimizer)
        self.scheduler = Scheduler(cfg.lr_policy, cfg.learning_rate,
                                   cfg.niter, cfg.niter_decay, cfg.gamma,
                                   cfg.lr_decay_iters)
        self._train_steps: Dict[str, Callable] = {}
        self._eval_steps: Dict[str, Callable] = {}
        self._val_infer = None
        # dropout's draws, each rank its own
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(cfg.seed + 1, dp.rank if dp is not None else 0))

        # best-model policy: BEV the minimum exact area; BP the maximum
        # test accuracy with clas, else the minimum validation loss
        self.minimize = cfg.profile == "bev" or not cfg.clas
        self.best_score = np.inf if self.minimize else -np.inf
        self.best_epoch = 0
        self.start_epoch = cfg.start_epoch

        if log_to_file and self.is_main:
            sys.stdout = Logger(os.path.join(
                self.save_path, f"log_train_start_{self.start_epoch}.txt"))
        if self.verbose:
            n_params = sum(p.numel() for p in self.lanenet.parameters())
            print("Number of parameters in model {} is {:.3f}M".format(
                cfg.mod.upper(), n_params / 1e6))

    # ------------------------------------------------------------------
    def train_step_for(self, phase: str) -> Callable:
        """step(batch, generator) -> metrics for `phase` (made once)."""
        if phase not in self._train_steps:
            self._train_steps[phase] = make_train_step(
                self.lanenet, self.cfg, self.optimizer, phase,
                device=self.device, state=self.state, group=self.group)
        return self._train_steps[phase]

    def eval_step_for(self, phase: str) -> Callable:
        """step(batch) -> (metrics, outputs) for `phase` (made once)."""
        if phase not in self._eval_steps:
            self._eval_steps[phase] = make_eval_step(
                self.lanenet, self.cfg, phase, device=self.device,
                group=self.group)
        return self._eval_steps[phase]

    def _prefetch(self, loader):
        return DevicePrefetcher(loader, self.device, depth=self.cfg.prefetch)

    def _from_main(self, value: Optional[float]) -> Optional[float]:
        """Rank 0's `value` on every rank (itself on one device)."""
        if self.group is None:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def load(self, path: str):
        """Load a checkpoint into the state on every rank -> payload."""
        _, payload = load_checkpoint(path, self.state, self.group)
        replicate(self.lanenet, self.group)
        return payload

    def test_score(self, test_loader) -> float:
        """The TuSimple test accuracy of the current weights: on rank 0
        alone (JAX's `test_model` is unsharded), the others wait and
        receive it."""
        score = None
        if self.is_main:
            score = test_model(test_loader, self.lanenet, self.cfg,
                               save_path=self.save_path,
                               verbose=self.verbose)
        return self._from_main(score)

    # ------------------------------------------------------------------
    def maybe_resume(self) -> bool:
        """Resume from the latest epoch checkpoint of the run directory."""
        if self.group is not None:
            dist.barrier(group=self.group)
        epoch = latest_checkpoint_epoch(self.save_path)
        if epoch is None:
            return False
        payload = self.load(_ckpt_path(self.save_path, epoch))
        self.start_epoch = payload["epoch"]
        self.best_epoch = payload["best epoch"]
        self.best_score = payload["loss"]
        if self.verbose:
            print("=> loaded checkpoint (epoch {})".format(payload["epoch"]))
        return True

    # ------------------------------------------------------------------
    def train_epoch(self, train_loader, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        phase = cfg.phase_for_epoch(epoch)
        if cfg.lr_policy in ("lambda", "step"):
            lr = self.scheduler.epoch_lr(epoch)
            set_lr(self.optimizer, lr)
            if self.verbose:
                print("lr is set to {}".format(lr))
        step = self.train_step_for(phase)
        train_loader.set_epoch(epoch)

        meters: Dict[str, AverageMeter] = {}
        batch_time, data_time = AverageMeter(), AverageMeter()
        end = time.time()
        bs = cfg.batch_size
        for i, batch in enumerate(self._prefetch(train_loader)):
            data_time.update(time.time() - end)
            metrics = _floats(step(batch, self.generator))
            batch_time.update(time.time() - end)
            end = time.time()
            for k, v in metrics.items():
                meters.setdefault(k, AverageMeter()).update(v, bs)
            if self.verbose and (i + 1) % cfg.print_freq == 0:
                print("Epoch: [{0}][{1}/{2}]\t"
                      "Time {bt.val:.3f} ({bt.avg:.3f})\t"
                      "Loss {loss.val:.8f} ({loss.avg:.8f})".format(
                          epoch + 1, i + 1, len(train_loader),
                          bt=batch_time, loss=meters["loss"]))
            if (cfg.save_freq and (i + 1) % cfg.save_freq == 0
                    and self.is_main):
                self.visualize_batch(batch, epoch, batch_idx=i + 1,
                                     mode="train")
                end = time.time()  # the panels are not the next batch's
        out = {k: m.avg for k, m in meters.items()}
        out["batch_time"] = batch_time.avg
        out["data_time"] = data_time.avg
        return out

    # ------------------------------------------------------------------
    def validate(self, valid_loader, epoch: int = 0,
                 valid_set_labels: Optional[list] = None
                 ) -> Dict[str, float]:
        """The validation pass: metric averages; with `clas` and the
        validation labels, the fitted-curve records of every image, and in
        the BEV profile with 4 lanes their LaneEval score (`acc_seg`); in
        the BP profile with `val_laneeval`, LaneEval on the validation
        split (`acc`). A skip epoch validates with the seg step."""
        cfg = self.cfg
        phase = cfg.phase_for_epoch(epoch)
        if phase == "skip":
            phase = "seg"
        step = self.eval_step_for(phase)
        bp_laneeval = (cfg.val_laneeval and cfg.profile == "bp" and cfg.clas
                       and cfg.end_to_end and phase == "e2e"
                       and valid_set_labels is not None)
        if bp_laneeval and self._val_infer is None:
            self._val_infer = make_infer_fn(
                self.lanenet, cfg,
                Projections(cfg.resize, cfg.order, cfg.no_mapping,
                            device=self.device))
        lanes_pred_all = []
        meters: Dict[str, AverageMeter] = {}
        records = []
        counter = 0
        for i, batch in enumerate(self._prefetch(valid_loader)):
            metrics, outputs = step(batch)
            if bp_laneeval:
                lanes_pred_all.append(gather_rows(self._val_infer(
                    prepare_batch(batch)["image"]), self.group).cpu().numpy())
            if (i + 1) % 25 == 0 and self.is_main:
                self.visualize_batch(batch, epoch, batch_idx=i + 1,
                                     mode="valid")
            for k, v in _floats(metrics).items():
                meters.setdefault(k, AverageMeter()).update(
                    v, cfg.effective_val_batch_size)
            if cfg.clas and valid_set_labels is not None:
                beta = outputs["beta"].float().cpu().numpy()  # (B, C, o+1)
                B = beta.shape[0]
                # no head predictions in the seg phase: zeros, as in JAX
                line = (outputs["line_pred"].cpu().numpy()
                        if "line_pred" in outputs else np.zeros((B, 4)))
                horizon = (outputs["horizon_pred"].cpu().numpy()
                           if "horizon_pred" in outputs
                           else np.zeros((B, cfg.resize)))
                for j in range(beta.shape[0]):
                    rec = dict(valid_set_labels[counter])
                    rec["params"] = beta[j, : cfg.nclasses].tolist()
                    rec["line_id"] = line[j].astype(int).tolist()
                    rec["horizon_est"] = horizon[j].astype(float).tolist()
                    records.append(rec)
                    counter += 1
        out = {k: m.avg for k, m in meters.items()}

        if cfg.clas and valid_set_labels is not None and records:
            acc_seg = self._write_validation_records(records)
            if cfg.nclasses > 3 and cfg.profile == "bev":
                out["acc_seg"] = self._from_main(acc_seg)

        if bp_laneeval and lanes_pred_all:
            out["acc"] = self._from_main(
                self._score_validation_lanes(lanes_pred_all,
                                             valid_set_labels)
                if self.is_main else None)
        return out

    def _write_validation_records(self, records) -> Optional[float]:
        """Rank 0: `validation_set_dst.json`, and in the BEV profile with 4
        lanes its TuSimple lines (`ls_result.json`) and their LaneEval
        score, returned (None otherwise, and on the other ranks)."""
        cfg = self.cfg
        if not self.is_main:
            return None
        val_set_path = os.path.join(self.save_path, "validation_set_dst.json")
        write_json_lines(val_set_path, records)
        if not (cfg.nclasses > 3 and cfg.profile == "bev"):
            return None
        ls_result_path = os.path.join(self.save_path, "ls_result.json")
        write_lsq_results(val_set_path, ls_result_path, cfg.nclasses,
                          False, False, cfg.resize, no_ortho=cfg.no_ortho)
        acc = LaneEval.bench_one_submit(ls_result_path, val_set_path)
        if self.verbose:
            print("===> Average ACC_SEG on val is {:.8}".format(acc[0]))
        return acc[0]

    def _score_validation_lanes(self, lanes_pred_all,
                                valid_set_labels) -> float:
        """Rank 0: LaneEval of the validation split's predicted lanes."""
        # valid_set_labels are TuSimple gt lines in loader order; rows
        # of a padded final batch are sliced off
        lanes = np.concatenate(lanes_pred_all, axis=0)
        n = min(lanes.shape[0], len(valid_set_labels))
        gt_path = os.path.join(self.save_path, "validation_gt.json")
        pred_path = os.path.join(self.save_path,
                                 "validation_predictions.json")
        write_json_lines(gt_path, valid_set_labels[:n])
        preds = []
        for j in range(n):
            rec = dict(valid_set_labels[j])
            rec["lanes"] = np.int_(np.round(lanes[j])).tolist()
            rec["run_time"] = 20
            preds.append(rec)
        write_json_lines(pred_path, preds)
        acc = LaneEval.bench_one_submit(pred_path, gt_path)
        if self.verbose:
            print("===> Average LaneEval ACC on val is {:.8}".format(
                acc[0]))
        return acc[0]

    # ------------------------------------------------------------------
    def fit(self, train_loader, valid_loader, test_loader=None,
            valid_set_labels: Optional[list] = None,
            nepochs: Optional[int] = None) -> Dict[str, float]:
        """The epoch loop from `start_epoch`. Returns the last epoch's
        metrics."""
        cfg = self.cfg
        last: Dict[str, float] = {}
        for epoch in range(self.start_epoch, nepochs or cfg.nepochs):
            if self.verbose:
                print("\n => Start train set for EPOCH {}".format(epoch + 1))
            phase = cfg.phase_for_epoch(epoch)
            train_metrics = self.train_epoch(train_loader, epoch)
            last = {f"train_{k}": v for k, v in train_metrics.items()}
            if self.verbose:
                print("===> Average loss on training set is {:.8f}".format(
                    train_metrics["loss"]))

            if phase == "skip":
                # no validation in the BP warm-up epochs
                self._checkpoint(epoch, score=None)
                self._log_scalars(epoch, last)
                continue

            if valid_loader is not None and len(valid_loader) > 0:
                val_metrics = self.validate(valid_loader, epoch,
                                            valid_set_labels)
            else:
                if self.is_main:
                    print(EMPTY_VALIDATION)
                val_metrics = {"loss": train_metrics["loss"]}
            last.update({f"val_{k}": v for k, v in val_metrics.items()})
            if self.verbose:
                print("===> Average loss on validation set is {:.8f}".format(
                    val_metrics["loss"]))

            if cfg.profile == "bev":
                score = val_metrics.get("exact_area", val_metrics["loss"])
            elif cfg.clas and test_loader is not None and cfg.end_to_end:
                score = self.test_score(test_loader)
                last["test_acc"] = score
            else:
                score = val_metrics["loss"]

            if cfg.lr_policy == "plateau":
                lr = self.scheduler.plateau_step(score)
                set_lr(self.optimizer, lr)
                if self.verbose:
                    print("LR plateaued, hence is set to {}".format(lr))

            self._checkpoint(epoch, score)
            self._log_scalars(epoch, last)
        return last

    def _log_scalars(self, epoch: int, metrics: Dict[str, float]) -> None:
        """One line of `scalars.jsonl` per epoch: the epoch, the learning
        rate and the epoch's metrics."""
        if not self.is_main:
            return
        rec = {"epoch": epoch + 1, "lr": get_lr(self.optimizer)}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(os.path.join(self.save_path, "scalars.jsonl"), "a") as f:
            json.dump(rec, f)
            f.write("\n")

    # ------------------------------------------------------------------
    def visualize_batch(self, batch, epoch: int, batch_idx: int = 0,
                        mode: str = "train") -> str:
        """The panels of sample 0 (`train/visualize.py`) from the eval
        forward of the current weights in the epoch's phase: a skip
        epoch's input, gt and argmax, else the weight maps and curves."""
        phase = self.cfg.phase_for_epoch(epoch)
        batch = prepare_batch(batch)
        out = self.lanenet.forward(batch["image"].to(self.device),
                                   phase=phase, train=False,
                                   dtype=self.cfg.torch_dtype())
        if phase == "skip":
            return save_pretrain_panel(batch["image"], batch["gt"],
                                       out.seg_logits, self.save_path,
                                       batch_idx)
        gt = batch.get("params", batch.get("lanes"))
        return save_weightmap(mode, out.weightmaps, out.beta, gt,
                              batch["image"], self.save_path, batch_idx,
                              resize=self.cfg.resize,
                              normalized=self.cfg.profile == "bev")

    # ------------------------------------------------------------------
    def _checkpoint(self, epoch: int, score: Optional[float]):
        is_best = False
        if score is not None:
            better = (score < self.best_score if self.minimize
                      else score > self.best_score)
            if better:
                is_best = True
                self.best_epoch = epoch + 1
                self.best_score = float(score)
        save_checkpoint(self.save_path, self.state, epoch, self.best_epoch,
                        self.best_score, self.cfg.mod, is_best, self.group)
