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

Program spans: `span(name)` marks a phase of the program (the train
step's forward, fit and losses, backward and optimizer; the serving
call's input copy, backbone, heads and lane projection). While no
`torch.profiler` records in the process it returns one shared no-op
context and costs one check. While one records, it opens a
`record_function` range of that name, so the phase is a range in the
same chrome trace as the device events, and keeps a record (a bounded
list, `SPAN_LIMIT`, oldest dropped first): its enclosing span, the root
id shared by a step's or call's spans, the host clock's start and end,
and at a root on a card the caching allocator's `cudaMalloc` calls.

    with trace("/tmp/mytrace") as t:
        for _ in range(20):
            metrics = step(batch, generator)    # spans train.step, ...
        torch.cuda.synchronize()
    print(summarize(t.dir, iters=20).format()) # busy and kernels by span
    print(span_summary()["train.step"])        # host ms, cudaMalloc calls

A span's device time is the trace's: `summarize(...).by_span` gives the
busy time (the union of the device intervals) and kernel count of each
span, a device event going to the innermost span open on the thread that
launched it. (The time between two CUDA events at a span's ends would
also hold the device's idle time while the traced host falls behind.)
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import gzip
import itertools
import json
import os
import re
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager, nullcontext
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
class SpanRow:
    name: str          # a program span, or OUTSIDE
    busy_us: float     # the union of its device events' intervals
    kernels: int


OUTSIDE = "(no span)"  # the row of device events launched outside any span


@dataclasses.dataclass
class TraceSummary:
    """Aggregated device-event times from one trace.

    `total_us` sums the events' durations (kernels that overlap, as a
    programmatic dependent launch overlaps the kernel before it, count
    twice); `busy_us` is the union of their intervals. `by_category`
    groups events by `category(name)`; `by_op` keeps full names;
    `by_span` groups them by the innermost program span open where they
    were launched. All are sorted by time, largest first."""

    total_us: float
    iters: int
    by_category: List[OpRow]
    by_op: List[OpRow]
    busy_us: float = 0.0
    by_span: List[SpanRow] = dataclasses.field(default_factory=list)

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
        lines = [f"device busy {self.busy_us / self.iters:.0f} us/iter "
                 "(union of device intervals)",
                 f"total device op time {self.total_us / self.iters:.0f} "
                 "us/iter"]
        for row in self.by_category[:top]:
            lines.append(f"  {row.total_us / self.iters:9.1f} us/iter  "
                         f"n={row.count:5d}  {row.name}")
        if self.by_span:
            lines.append("--- by span (busy us/iter, kernels/iter)")
        for row in self.by_span:
            lines.append(f"  {row.busy_us / self.iters:9.1f}  "
                         f"{row.kernels / self.iters:8.1f}  {row.name}")
        lines.append("--- top single ops")
        for row in self.by_op[:15]:
            lines.append(f"  {row.total_us / self.iters:9.1f}  "
                         f"{row.name[:160]}")
        return "\n".join(lines)


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


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


def _is_span(e: dict) -> bool:
    """A host range opened by `record_function`: the program's spans and
    its callers' ranges, not PyTorch's own (`Optimizer.step#Adam.step`,
    `ProfilerStep#3`: their names hold a '#')."""
    return e.get("cat") == "user_annotation" and "#" not in e["name"]


def _innermost(spans: List[tuple], ts: float) -> Optional[tuple]:
    """Of (start, end, name) ranges, the one that started last of those
    open at `ts`."""
    best = None
    for s in spans:
        if s[0] <= ts <= s[1] and (best is None or s[0] > best[0]):
            best = s
    return best


def summarize(trace_dir: str, iters: int = 1,
              device_substr: Tuple[str, ...] = DEVICE) -> TraceSummary:
    """Aggregate the device events of the newest trace in `trace_dir`.

    An event counts when it is complete (`ph` "X", with a duration) and
    its category (`cat`, lower-cased) contains one of `device_substr`:
    by default the card's kernels, memcpys and memsets (`DEVICE`); pass
    `CPU` on a host without a card for its operator events. `iters`
    divides the per-iteration figures.

    `by_span`: a device event is launched by the host runtime call that
    shares its `args.correlation` (an event without one, a host operator
    say, stands for itself), and goes to the innermost span (`_is_span`)
    open on that call's thread then. Autograd runs a backward's CUDA work
    on a thread of its own, where no span is open: such a launch goes to
    the innermost span open then on another thread of its process (the
    one that waits in `loss.backward()`)."""
    with gzip.open(_latest_trace_file(trace_dir), "rt") as fh:
        tr = json.load(fh)
    cat_us: Dict[str, float] = collections.Counter()
    cat_n: Dict[str, int] = collections.Counter()
    op_us: Dict[str, float] = collections.Counter()
    op_n: Dict[str, int] = collections.Counter()
    device, launches = [], {}
    spans: Dict[tuple, List[tuple]] = collections.defaultdict(list)
    for e in tr.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        where = (e.get("pid"), e.get("tid"), float(e["ts"]))
        if _is_span(e):
            spans[where[:2]].append((where[2], where[2] + e["dur"],
                                     e["name"]))
        if cat in ("cuda_runtime", "cuda_driver"):
            launches[e.get("args", {}).get("correlation")] = where
        if not any(s in cat for s in device_substr):
            continue
        name = e["name"]
        base = category(name)
        cat_us[base] += e["dur"]
        cat_n[base] += 1
        op_us[name] += e["dur"]
        op_n[name] += 1
        device.append((where, float(e["ts"]), float(e["ts"]) + e["dur"],
                       "kernel" in cat, e.get("args", {}).get("correlation")))
    in_pid: Dict[object, List[tuple]] = collections.defaultdict(list)
    for (pid, _), rs in spans.items():
        in_pid[pid].extend(rs)
    span_iv: Dict[str, list] = collections.defaultdict(list)
    span_k: Dict[str, int] = collections.Counter()
    for own, s, t, kernel, corr in device:
        pid, tid, ts = launches.get(corr, own)
        hit = (_innermost(spans.get((pid, tid), []), ts)
               or _innermost(in_pid.get(pid, []), ts))
        name = hit[2] if hit else OUTSIDE
        span_iv[name].append((s, t))
        span_k[name] += kernel
    by_span = sorted((SpanRow(n, _union_us(iv), span_k[n])
                      for n, iv in span_iv.items()),
                     key=lambda r: -r.busy_us)
    by_cat = [OpRow(k, v, cat_n[k]) for k, v in cat_us.most_common()]
    by_op = [OpRow(k, v, op_n[k]) for k, v in op_us.most_common()]
    return TraceSummary(total_us=sum(cat_us.values()), iters=iters,
                        by_category=by_cat, by_op=by_op,
                        busy_us=_union_us([(s, t) for _, s, t, _, _ in
                                          device]),
                        by_span=by_span)


# ----------------------------------------------------------------------
# program spans
# ----------------------------------------------------------------------

SPAN_LIMIT = 4096  # span records kept; the oldest are dropped first


@dataclasses.dataclass
class SpanRecord:
    """One span. `index` numbers the spans in the order they opened;
    `parent` is the enclosing span's index (None at a root); `root` the id
    shared by every span of one step or call. Host times are
    `time.perf_counter_ns()`. `mallocs`, at a root on a card: the caching
    allocator's `cudaMalloc` calls (`segment.all.allocated`) over the
    span."""

    index: int
    name: str
    parent: Optional[int]
    root: int
    host_start_ns: int
    host_end_ns: Optional[int] = None
    mallocs: Optional[int] = None

    @property
    def host_ms(self) -> Optional[float]:
        if self.host_end_ns is None:
            return None
        return (self.host_end_ns - self.host_start_ns) * 1e-6


_RECORDS = collections.deque(maxlen=SPAN_LIMIT)
_INDICES = itertools.count()
_ROOTS = itertools.count()
_OPEN = threading.local()  # each thread's stack of open spans
_OFF = nullcontext()


def _stack() -> list:
    if not hasattr(_OPEN, "stack"):
        _OPEN.stack = []
    return _OPEN.stack


def _card(device) -> Optional[int]:
    """The card of a span on `device`: a CUDA `device`, or where None the
    current card once CUDA is initialized; else None."""
    if device is None:
        return (torch.cuda.current_device() if torch.cuda.is_initialized()
                else None)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _mallocs(card: int) -> int:
    return torch.cuda.memory_stats_as_nested_dict(card)[
        "segment"]["all"]["allocated"]


class _Span:
    __slots__ = ("name", "device", "root", "rec", "fn", "card", "mallocs")

    def __init__(self, name: str, device, root: Optional[int]):
        self.name, self.device, self.root = name, device, root

    def __enter__(self) -> SpanRecord:
        stack = _stack()
        parent = stack[-1] if stack else None
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        if parent is not None:
            root = parent.root
        else:
            root = self.root if self.root is not None else next(_ROOTS)
        rec = self.rec = SpanRecord(
            next(_INDICES), self.name,
            None if parent is None else parent.index, root, 0)
        self.card = _card(self.device) if parent is None else None
        if self.card is not None:
            self.mallocs = _mallocs(self.card)
        _RECORDS.append(rec)
        stack.append(rec)
        rec.host_start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        t = time.perf_counter_ns()
        _stack().pop()
        if self.card is not None:
            self.rec.mallocs = _mallocs(self.card) - self.mallocs
        self.rec.host_end_ns = t
        self.fn.__exit__(*exc)
        return False


def span(name: str, device=None, root: Optional[int] = None):
    """A context that marks a phase of the program named `name`, on
    `device` (where it is a card, a root span counts its `cudaMalloc`
    calls; None: the current card once CUDA is initialized). `root`: the
    id of the step or call when this span is a root (no span open on the
    thread); children take their root's, and a root without one numbers
    itself.

    While no `torch.profiler` records in the process (`torch.autograd.
    _profiler_enabled()` False) this returns one shared no-op context:
    no allocation, no CUDA call, no record."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, device, root)


def span_records() -> List[SpanRecord]:
    """The kept records, oldest first."""
    return list(_RECORDS)


def reset_spans() -> None:
    """Drop every record."""
    _RECORDS.clear()


def _mean(values) -> Optional[float]:
    values = list(values)
    if not values or any(v is None for v in values):
        return None
    return sum(values) / len(values)


def span_summary() -> Dict[str, Dict[str, Optional[float]]]:
    """Per span name over its closed records: `count`, and the means of
    `host_ms` and `mallocs` (None where a record has no count: on the
    CPU, below a root). The device time of each span is the trace's:
    `summarize(...).by_span`."""
    by_name: Dict[str, List[SpanRecord]] = collections.defaultdict(list)
    for r in span_records():
        if r.host_end_ns is not None:
            by_name[r.name].append(r)
    return {name: {"count": len(rs),
                   "host_ms": _mean(r.host_ms for r in rs),
                   "mallocs": _mean(r.mallocs for r in rs)}
            for name, rs in by_name.items()}
