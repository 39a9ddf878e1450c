"""cuda_mallocs.<family>: the caching allocator's `cudaMalloc` calls
(`torch.cuda.memory_stats()`' `segment.all.allocated`) over a traced step
or call, as the program's root span (`train.step`, `serve.call`) counts
them (`utils/profiling.py::span_records`), averaged over the run's last
`traced_units` roots. None without the program's span records: on the
CPU, or in a program that has no spans."""

from lanedetection_end2end_tpu_torch.utils import profiling

ROOTS = {"train": "train.step", "serve": "serve.call"}


def read(run):
    records = getattr(profiling, "span_records", None)
    if run.trace is None or records is None or run.traced_units <= 0:
        return None
    roots = [r for r in records() if r.parent is None
             and r.name == ROOTS[run.family] and r.host_end_ns is not None]
    counts = [r.mallocs for r in roots[-run.traced_units:]]
    if not counts or None in counts:
        return None
    return sum(counts) / len(counts)
