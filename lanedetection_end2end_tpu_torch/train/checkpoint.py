"""Checkpoint save and resume with the reference's lifecycle.

Counterpart of `lanedetection_end2end_tpu/train/checkpoint.py`: one file
per epoch, `checkpoint_model_epoch_{e}.pkl` (the previous epoch's file is
deleted), a copy `model_best_epoch_{e}.pkl` on improvement (the older best
deleted), and the `first_run.txt` marker holding the latest epoch. The
payload has the same keys, `epoch`, `best epoch`, `arch`, `loss` and
`state_dict`; here `state_dict` holds the torch `state_dict`s of the model
and the optimizer and the steps taken, written with `torch.save`. A JAX
checkpoint does not load here.
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Optional

import torch

from lanedetection_end2end_tpu_torch.train.state import TrainState
from lanedetection_end2end_tpu_torch.utils.observability import (
    write_run_marker)


def _ckpt_path(save_path: str, epoch: int) -> str:
    return os.path.join(save_path, f"checkpoint_model_epoch_{epoch}.pkl")


def save_checkpoint(save_path: str, state: TrainState, epoch: int,
                    best_epoch: int, best_score: float, arch: str = "erfnet",
                    is_best: bool = False) -> str:
    """Write epoch `epoch`'s checkpoint, copy it to model_best on
    improvement, delete the previous epoch's and update first_run.txt."""
    payload = {
        "epoch": epoch + 1,
        "best epoch": best_epoch,
        "arch": arch,
        "loss": best_score,
        "state_dict": {"model": state.model.state_dict(),
                       "optimizer": state.optimizer.state_dict(),
                       "step": state.step},
    }
    filepath = _ckpt_path(save_path, epoch)
    tmp = filepath + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, filepath)
    if is_best:
        for old in glob.glob(os.path.join(save_path, "model_best_epoch_*.pkl")):
            os.remove(old)
        shutil.copyfile(
            filepath, os.path.join(save_path, f"model_best_epoch_{epoch}.pkl"))
    prev = _ckpt_path(save_path, epoch - 1)
    if os.path.exists(prev):
        os.remove(prev)
    write_run_marker(save_path, epoch)
    return filepath


def latest_checkpoint_epoch(save_path: str) -> Optional[int]:
    """The epoch recorded in first_run.txt, if its checkpoint exists."""
    marker = os.path.join(save_path, "first_run.txt")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        text = f.read().strip()
    if not text:
        return None
    epoch = int(text)
    return epoch if os.path.exists(_ckpt_path(save_path, epoch)) else None


def load_checkpoint(path: str, state: TrainState):
    """Load the checkpoint at `path` into `state` (its model and optimizer,
    in place, on the model's device) -> (state, payload)."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=False)
    sd = payload["state_dict"]
    state.model.load_state_dict(sd["model"])
    state.optimizer.load_state_dict(sd["optimizer"])
    state.step = sd["step"]
    return state, payload


def best_checkpoint_path(save_path: str) -> Optional[str]:
    """The model_best* file of a run directory, if there is one."""
    matches = sorted(glob.glob(os.path.join(save_path, "model_best*")))
    return matches[0] if matches else None
