"""Capture of a profiled stretch of a run, and its reduction to what the
per-layer metrics read.

The event parsing is a frozen copy of the program's trace tool: a device
event is a complete event (`ph` "X") whose category names a kernel, a
memcpy or a memset; a kernel's category is its function's name without
return type, anonymous namespace, template arguments and parameters.
Added here: the union of the device intervals (overlapping launches, as
programmatic dependent launches overlap the kernel before them, count
once), the idle gaps inside the traced window, each named by the host
operation running through it, and the kernels counted.

The traced window is the span of the `portbench.window` range that the
traffic opens around its profiled steps and their closing synchronize.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import tempfile
from contextlib import contextmanager
from typing import Dict, List, Tuple

DEVICE = ("kernel", "memcpy", "memset")
HOST = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "portbench.window"


def category(name: str) -> str:
    """`void (anonymous namespace)::dyv_kernel<float, 64>(float const*)`
    -> `dyv_kernel`; trailing `.N` suffixes stripped."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[len("void "):]
    base = re.split(r"[<(]", base, maxsplit=1)[0].strip()
    return re.sub(r"(\.\d+)+$", "", base) or name


@dataclasses.dataclass
class TraceStats:
    window_s: float                      # the traced window's length
    busy_s: float                        # union of device intervals in it
    kernels: int                         # device kernels in it
    device_ops: List[Tuple[str, float]]  # seconds by category, largest first
    idle_gaps: List[Tuple[str, float]]   # idle seconds by host op


def union_length(intervals: List[Tuple[float, float]]) -> Tuple[float, list]:
    """(total length of the union, the merged intervals in order)."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def name_gaps(gaps: List[Tuple[float, float]],
              host: List[Tuple[float, float, str]]) -> List[str]:
    """For each gap (in time order), the innermost host event running at
    its midpoint: of those covering it, the one that started last."""
    host = sorted(host)
    names, active, i = [], [], 0
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        names.append(max(active)[2] if active else "host: no traced op")
    return names


def reduce(events: List[dict], top: int = 10) -> TraceStats:
    """The traced window's stats from chrome-trace events (microseconds)."""
    win = [e for e in events if e.get("ph") == "X" and
           e.get("name") == WINDOW and "dur" in e]
    if not win:
        raise ValueError(f"no {WINDOW} range in the trace")
    w0 = min(e["ts"] for e in win)
    w1 = max(e["ts"] + e["dur"] for e in win)
    dev, host = [], []
    by_cat: Dict[str, float] = collections.Counter()
    kernels = 0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if any(k in cat for k in DEVICE):
            s, t = max(s, w0), min(t, w1)
            if t <= s:
                continue
            dev.append((s, t))
            by_cat[category(e["name"])] += (t - s) * 1e-6
            kernels += "kernel" in cat
        elif any(k in cat for k in HOST) and e["name"] != WINDOW:
            host.append((s, t, e["name"]))
    busy_us, merged = union_length(dev)
    idle, edge = [], w0
    for s, e in merged + [[w1, w1]]:
        if s > edge:
            idle.append((edge, s))
        edge = max(edge, e)
    gaps: Dict[str, float] = collections.Counter()
    for (s, e), name in zip(idle, name_gaps(idle, host)):
        gaps[name] += (e - s) * 1e-6
    return TraceStats(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                      kernels=kernels, device_ops=by_cat.most_common(top),
                      idle_gaps=gaps.most_common(top))


@contextmanager
def profiled():
    """Profile CPU and CUDA activity within the block, which must run its
    steps inside `window()`; yields a holder whose `.stats` is set to the
    reduced TraceStats when the block closes. The chrome trace goes to a
    temporary file under TMPDIR and is deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Traced", (), {"stats": None})()
    holder.window = lambda: record_function(WINDOW)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield holder
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.remove(path)
    holder.stats = reduce(events)
