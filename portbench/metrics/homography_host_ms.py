"""homography_host_ms.train: the host's milliseconds a traced step in the
program's `model.homography` span (the learned homography's head, its DLT
solve and each image's coefficient rows, `models/lanenet.py`), summed
over the spans under the run's last `traced_units` `train.step` roots
(`utils/profiling.py::span_records`) and divided by their count. The
host enqueues that work and does not wait for the card, so a wait for
the stream inside the DLT shows here first. None without such spans:
without a trace, or in a program that has no such span."""

from lanedetection_end2end_tpu_torch.utils import profiling


def read(run):
    records = getattr(profiling, "span_records", None)
    if run.trace is None or records is None or run.traced_units <= 0:
        return None
    recs = records()
    roots = [r for r in recs if r.parent is None and r.name == "train.step"
             and r.host_end_ns is not None][-run.traced_units:]
    ids = {r.root for r in roots}
    ms = [r.host_ms for r in recs if r.name == "model.homography"
          and r.root in ids and r.host_end_ns is not None]
    if not roots or not ms:
        return None
    return sum(ms) / len(roots)
