"""Shared fixtures of the benchmark's tests, and the `card` marker.

Run here (CPU) with `python -m pytest portbench/tests -p xdist -n 6`; the
tests marked `card` run only where `torch.cuda.is_available()`, which
each decides inside the test, and skip elsewhere.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from portbench import harness

SEED = 20260418


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; decides inside the test and "
        "skips without one")


def small_copy(dest: Path, cells: dict) -> tuple:
    """A copy of the benchmark's directory under `dest` with each cell of
    `cells` ({cell: (resize, batch)}) at that size; -> (BENCHMARK.json
    parsed, the copy's directory)."""
    bench_dir = dest / "portbench"
    shutil.copytree(harness.BENCH, bench_dir, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    bench = harness.read_json(harness.ROOT / "BENCHMARK.json")
    config = {w["name"]: w["config"] for w in bench["workloads"]}
    for cell, (resize, batch) in cells.items():
        wpath = bench_dir / "workloads" / f"{cell}.json"
        w = json.loads(wpath.read_text())
        w["traffic"]["batch"] = batch
        wpath.write_text(json.dumps(w))
        cpath = bench_dir / "configs" / f"{config[cell]}.json"
        c = json.loads(cpath.read_text())
        c["preset_kwargs"]["resize"] = resize
        c["model"]["resize"] = resize
        cpath.write_text(json.dumps(c))
    return bench, bench_dir


SMALL = {"bp_train_sh.train_b128": (32, 4), "bev_egolane.train_b128": (32, 4),
         "bp_train_sh.serve_b128": (64, 4)}


@pytest.fixture
def small(tmp_path):
    """The three cells at a size the CPU runs in seconds."""
    import torch
    torch.set_num_threads(1)
    return small_copy(tmp_path, SMALL)


def run_small(small, cell, seconds=0.5, trace=False, overrides=None):
    import time
    bench, bench_dir = small
    return harness.run(cell, SEED, seconds, trace, "cpu", time.perf_counter(),
                       bench=bench, overrides=overrides, bench_dir=bench_dir)
