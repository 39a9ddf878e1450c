"""Trace capture and per-op summaries of device time, on `torch.profiler`.

Counterpart of `lanedetection_end2end_tpu/utils/profiling.py`, with the
same names: `trace` records a few steps into a directory, `summarize`
aggregates the device events of the newest trace there into a table by
category and by op. A trace is a chrome trace (`*.trace.json.gz`) of CPU
and CUDA activity, so it also opens in Perfetto or chrome://tracing.

    from lanedetection_end2end_tpu_torch.utils.profiling import (
        summarize, trace)

    with trace("/tmp/mytrace") as t:
        for _ in range(20):
            out = step(x)
        torch.cuda.synchronize()
    print(summarize(t.dir, iters=20).format())

What counts as device work: the events whose category (`cat`) names a
kernel, a memcpy or a memset (`DEVICE`), the events on the card's
streams. The ranges that only span kernels (`gpu_user_annotation`) and
the host's runtime calls that launch them (`cuda_runtime`) are left out,
so nothing is counted twice. A kernel's category is its function's name
without the return type, template arguments and parameters, so every
instantiation of `conv3tap_f32_kernel<C, EPI>` falls into one; an
anonymous namespace is dropped from it. On a host without a card there
are no device events: pass `device_substr=CPU` there to summarize the
host's operator events instead (nested, so their sum counts a call and
the calls inside it; fine for smoke tests). The default never falls
back to them: a trace without device events gives an empty summary.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import gzip
import json
import os
import re
import shutil
import subprocess
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch

DEVICE = ("kernel", "memcpy", "memset")  # substrings of a device event's cat
CPU = ("cpu_op",)                        # the host's operator events


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` prints them for the first
    card: the harnesses print it beside every number."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class TraceHandle:
    dir: str
    # the finished `torch.profiler.profile` (its `key_averages()`), set
    # when the `with` block closes
    profiler: Optional[object] = None


@contextmanager
def trace(trace_dir: str):
    """Record CPU activity, and CUDA activity where a card is present,
    into a new `*.trace.json.gz` under `trace_dir` (created if missing).
    Yields a TraceHandle whose `.dir` feeds `summarize`.

    The profiler can lose device events: after the sessions of
    `chip_smoke.py --profile` (fourteen, of up to 8,000 device events
    each) a later session in the same process lost 9 of 759 and one
    after it 9 of 7,238 on an H100, `key_averages()` the same, while
    sixteen small sessions in a fresh process lost none. For exact
    counts, trace in a fresh process, as the harnesses do when run from
    their command lines."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handle = TraceHandle(trace_dir)
    with profile(activities=activities) as prof:
        yield handle
    handle.profiler = prof
    stem = os.path.join(trace_dir, f"{time.time_ns():020d}")
    prof.export_chrome_trace(stem + ".json")
    with open(stem + ".json", "rb") as src, \
            gzip.open(stem + ".trace.json.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(stem + ".json")


@dataclasses.dataclass
class OpRow:
    name: str
    total_us: float
    count: int


@dataclasses.dataclass
class TraceSummary:
    """Aggregated device-event times from one trace.

    `by_category` groups events by `category(name)`; `by_op` keeps full
    names. Both are sorted by total time, largest first."""

    total_us: float
    iters: int
    by_category: List[OpRow]
    by_op: List[OpRow]

    def us_per_iter(self, category: Optional[str] = None) -> float:
        if category is None:
            return self.total_us / self.iters
        for row in self.by_category:
            if row.name == category:
                return row.total_us / self.iters
        return 0.0

    def count_per_iter(self, substr: str) -> float:
        """Events per iteration whose full name contains `substr`."""
        return sum(r.count for r in self.by_op if substr in r.name) \
            / self.iters

    def format(self, top: int = 25) -> str:
        lines = [f"total device op time {self.total_us / self.iters:.0f} "
                 "us/iter"]
        for row in self.by_category[:top]:
            lines.append(f"  {row.total_us / self.iters:9.1f} us/iter  "
                         f"n={row.count:5d}  {row.name}")
        lines.append("--- top single ops")
        for row in self.by_op[:15]:
            lines.append(f"  {row.total_us / self.iters:9.1f}  "
                         f"{row.name[:160]}")
        return "\n".join(lines)


def _latest_trace_file(trace_dir: str) -> str:
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                             recursive=True))
    if not files:
        raise FileNotFoundError(f"no *.trace.json.gz under {trace_dir}")
    return files[-1]


def category(name: str) -> str:
    """An event's category: a kernel's function name without its return
    type, anonymous namespace, template arguments and parameters
    (`void (anonymous namespace)::dyv_kernel<float, 64>(float const*,
    ...)` -> `dyv_kernel`), then, as in JAX, trailing `.N` suffixes
    stripped (`fusion.123` -> `fusion`)."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[len("void "):]
    base = re.split(r"[<(]", base, maxsplit=1)[0].strip()
    return re.sub(r"(\.\d+)+$", "", base) or name


def summarize(trace_dir: str, iters: int = 1,
              device_substr: Tuple[str, ...] = DEVICE) -> TraceSummary:
    """Aggregate the device events of the newest trace in `trace_dir`.

    An event counts when it is complete (`ph` "X", with a duration) and
    its category (`cat`, lower-cased) contains one of `device_substr`:
    by default the card's kernels, memcpys and memsets (`DEVICE`); pass
    `CPU` on a host without a card for its operator events. `iters`
    divides the per-iteration figures."""
    with gzip.open(_latest_trace_file(trace_dir), "rt") as fh:
        tr = json.load(fh)
    cat_us: Dict[str, float] = collections.Counter()
    cat_n: Dict[str, int] = collections.Counter()
    op_us: Dict[str, float] = collections.Counter()
    op_n: Dict[str, int] = collections.Counter()
    for e in tr.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        if not any(s in cat for s in device_substr):
            continue
        name = e["name"]
        base = category(name)
        cat_us[base] += e["dur"]
        cat_n[base] += 1
        op_us[name] += e["dur"]
        op_n[name] += 1
    by_cat = [OpRow(k, v, cat_n[k]) for k, v in cat_us.most_common()]
    by_op = [OpRow(k, v, op_n[k]) for k, v in op_us.most_common()]
    return TraceSummary(total_us=sum(cat_us.values()), iters=iters,
                        by_category=by_cat, by_op=by_op)
