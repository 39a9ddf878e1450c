"""Observability primitives: running meters, stdout tee, run-dir helpers.

The port's copy of `lanedetection_end2end_tpu/utils/observability.py`,
after Networks/utils.py of the reference:
- AverageMeter (utils.py:393-408)
- Logger stdout tee (utils.py:355-390)
- first_run marker file (utils.py:323-333)
- mkdir_if_missing (utils.py:336-343)
"""

from __future__ import annotations

import errno
import os
import sys


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def mkdir_if_missing(directory: str) -> None:
    if not os.path.exists(directory):
        try:
            os.makedirs(directory)
        except OSError as e:
            if e.errno != errno.EEXIST:
                raise


def first_run(save_path: str) -> str:
    """Latest-epoch marker: returns '' on first run, else the saved epoch
    string (utils.py:323-333). The driver writes the epoch each epoch end."""
    txt_file = os.path.join(save_path, "first_run.txt")
    if not os.path.exists(txt_file):
        open(txt_file, "w").close()
        return ""
    with open(txt_file) as f:
        saved_epoch = f.read().strip()
    return saved_epoch or ""


def write_run_marker(save_path: str, epoch: int) -> None:
    with open(os.path.join(save_path, "first_run.txt"), "w") as f:
        f.write(str(epoch))


class Logger:
    """Tee stdout to a log file (console + per-run log, utils.py:355-390).

    Use: sys.stdout = Logger(os.path.join(save_path, 'train.log'))
    """

    def __init__(self, fpath: str | None = None):
        self.console = sys.stdout
        self.file = None
        if fpath is not None:
            mkdir_if_missing(os.path.dirname(fpath))
            self.file = open(fpath, "w")

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def write(self, msg):
        self.console.write(msg)
        if self.file is not None:
            self.file.write(msg)

    def flush(self):
        self.console.flush()
        if self.file is not None:
            self.file.flush()
            os.fsync(self.file.fileno())

    def close(self):
        self.console.flush()
        if self.file is not None:
            self.file.close()
            self.file = None
