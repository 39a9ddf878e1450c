"""The port's trace tool (`utils/profiling.py`) on the CPU, as
tests/test_profiling.py runs the JAX package's: a `torch.profiler` trace of
a few matmuls summarized with the host's operator events
(`device_substr=CPU`, there are no device lanes here), and, with the
default, an empty summary (no fallback to host events). Then `summarize`
on a hand-written chrome trace shaped as a card's: kernels with templated
and anonymous-namespace names, a memcpy and a memset, a
`gpu_user_annotation` range over the kernels, a host runtime launch, a
host operator, flow and metadata events, with exact totals and
categories. Then the three harnesses built on it
(`tools/prof_infer.py`, `prof_train.py`, `prof_feed.py`) at small counts:
each refuses to run without a card unless asked for the CPU, and each
measures what it names. Last the program's spans: off without a
profiler, the train step's and the serving call's phases under one, the
bounded list, and `by_span` / `busy_us` on a hand-written trace."""

import gzip
import json

import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu_torch.tools import (
    prof_feed, prof_infer, prof_train)
from lanedetection_end2end_tpu_torch.utils import profiling
from lanedetection_end2end_tpu_torch.utils.profiling import (
    CPU, OUTSIDE, SPAN_LIMIT, category, reset_spans, span, span_records,
    span_summary, summarize, trace)
from test_torch_threads import one_torch_thread  # noqa: F401


def test_trace_and_summarize(tmp_path):
    a = torch.ones(128, 128)
    f = lambda a, b: a @ b + 1.0
    f(a, a)
    iters = 5
    with trace(str(tmp_path)) as t:
        for _ in range(iters):
            f(a, a)
    assert t.profiler is not None
    files = list(tmp_path.glob("*.trace.json.gz"))
    assert len(files) == 1
    s = summarize(t.dir, iters=iters, device_substr=CPU)
    assert s.total_us > 0
    assert s.by_category, "expected at least one op category"
    assert "us/iter" in s.format()
    names = {row.name for row in s.by_category}
    assert "aten::matmul" in names or "aten::mm" in names, names
    # no card here: the default finds no device event and falls back to
    # nothing
    empty = summarize(t.dir, iters=iters)
    assert empty.total_us == 0 and not empty.by_category


def test_us_per_iter_missing_category_is_zero(tmp_path):
    a = torch.ones(64, 64)
    with trace(str(tmp_path)) as t:
        a * 2.0
    s = summarize(t.dir, iters=1, device_substr=CPU)
    assert s.us_per_iter("definitely_not_a_real_op") == 0.0
    assert s.us_per_iter() == s.total_us


def test_newest_trace_is_read(tmp_path):
    a = torch.ones(32, 32)
    with trace(str(tmp_path)):
        a + 1.0
    with trace(str(tmp_path)) as t:
        a @ a
    assert len(list(tmp_path.glob("*.trace.json.gz"))) == 2
    names = {row.name for row in summarize(t.dir, device_substr=CPU).by_op}
    assert "aten::add" not in names and "aten::matmul" in names


KERNEL_A = ("void ldconv32::conv3tap_f32_kernel<64, 1>(float const*, "
            "float const*, float*, int, int)")
KERNEL_A2 = ("void ldconv32::conv3tap_f32_kernel<128, 2>(float const*, "
             "float const*, float*, int, int)")
KERNEL_B = ("void (anonymous namespace)::dyv_kernel<float, 64>(float "
            "const*, float*, long long)")
KERNEL_C = "encoder_fused_kernel(ldenc::Params)"
KERNEL_D = "sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32.123"


def _write_trace(path):
    ev = [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "process_name", "pid": 77,
         "args": {"name": "python"}},
        # host side: an operator and the runtime call that launches
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 77,
         "tid": 1, "ts": 0.0, "dur": 500.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 77, "tid": 1, "ts": 10.0, "dur": 4.0},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": 77, "tid": 1,
         "ts": 10.0, "id": 1},
        # the card: a range over the kernels, then the kernels
        {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step",
         "pid": 0, "tid": 7, "ts": 20.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": KERNEL_A, "pid": 0, "tid": 7,
         "ts": 20.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": KERNEL_A, "pid": 0, "tid": 7,
         "ts": 31.0, "dur": 12.5},
        {"ph": "X", "cat": "kernel", "name": KERNEL_A2, "pid": 0, "tid": 7,
         "ts": 44.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": KERNEL_B, "pid": 0, "tid": 7,
         "ts": 65.0, "dur": 3.0},
        {"ph": "X", "cat": "kernel", "name": KERNEL_C, "pid": 0, "tid": 7,
         "ts": 70.0, "dur": 40.0},
        {"ph": "X", "cat": "kernel", "name": KERNEL_D, "pid": 0, "tid": 7,
         "ts": 111.0, "dur": 5.0},
        {"ph": "X", "cat": "gpu_memcpy",
         "name": "Memcpy HtoD (Pinned -> Device)", "pid": 0, "tid": 8,
         "ts": 0.0, "dur": 7.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "pid": 0, "tid": 7, "ts": 18.0, "dur": 1.5},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 7,
         "ts": 20.0, "id": 1},
        # an instant and a complete event with no duration are skipped
        {"ph": "i", "cat": "kernel", "name": "marker", "pid": 0, "tid": 7,
         "ts": 1.0},
        {"ph": "X", "cat": "kernel", "name": "no duration", "pid": 0,
         "tid": 7, "ts": 2.0},
    ]
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": ev}, fh)


def test_summarize_counts_device_events_once(tmp_path):
    _write_trace(tmp_path / "0001.trace.json.gz")
    s = summarize(str(tmp_path), iters=2)
    assert s.total_us == 10.0 + 12.5 + 20.0 + 3.0 + 40.0 + 5.0 + 7.0 + 1.5
    got = {r.name: (r.total_us, r.count) for r in s.by_category}
    assert got == {
        "ldconv32::conv3tap_f32_kernel": (42.5, 3),
        "dyv_kernel": (3.0, 1),
        "encoder_fused_kernel": (40.0, 1),
        "sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32": (
            5.0, 1),
        "Memcpy HtoD": (7.0, 1),
        "Memset": (1.5, 1)}
    assert [r.name for r in s.by_category][:2] == [
        "ldconv32::conv3tap_f32_kernel", "encoder_fused_kernel"]
    ops = {r.name: (r.total_us, r.count) for r in s.by_op}
    assert ops[KERNEL_A] == (22.5, 2) and ops[KERNEL_A2] == (20.0, 1)
    assert len(ops) == 7
    assert s.us_per_iter() == s.total_us / 2
    assert s.us_per_iter("dyv_kernel") == 1.5
    assert s.count_per_iter("conv3tap_f32_kernel") == 1.5
    assert s.count_per_iter("<64, 1>") == 1.0
    text = s.format(top=3)
    assert s.busy_us == 99.0  # no two events overlap here
    assert text.splitlines()[:2] == [
        "device busy 50 us/iter (union of device intervals)",
        "total device op time 50 us/iter"]
    assert "n=    3  ldconv32::conv3tap_f32_kernel" in text


def test_summarize_host_events_on_request(tmp_path):
    _write_trace(tmp_path / "0001.trace.json.gz")
    s = summarize(str(tmp_path), device_substr=CPU)
    assert s.total_us == 500.0
    assert [(r.name, r.count) for r in s.by_category] == [
        ("aten::conv2d", 1)]


def test_category_rule():
    assert category(KERNEL_B) == "dyv_kernel"
    assert category("fusion.123") == "fusion"
    assert category("aten::mm") == "aten::mm"
    assert category("Memset (Device)") == "Memset"
    assert category("void at::native::vectorized_elementwise_kernel<4, "
                    "at::native::FillFunctor<float>>(int, ...)") == (
        "at::native::vectorized_elementwise_kernel")


# ----------------------------------------------------------------------
# the three harnesses on the CPU, at small counts
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tool", [prof_infer, prof_train, prof_feed])
def test_harness_refuses_to_run_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])


def test_prof_infer_runs_the_engine(tmp_path):
    res = prof_infer.run(bs=2, warm=1, timed=1, traced=2,
                         trace_dir=str(tmp_path), device="cpu", resize=64)
    assert res["img_per_s"] > 0 and res["ms_per_batch"] > 0
    assert res["lanes"].shape == (2, 4, 56)
    # no device events on the host; its operators are in the trace
    assert res["summary"].total_us == 0
    host = summarize(res["trace"].dir, iters=2, device_substr=CPU)
    assert host.count_per_iter("aten::") > 0


def test_prof_train_steps_on_the_plain_versions(tmp_path):
    res = prof_train.run(bs=2, warm=1, timed=1, traced=2,
                         trace_dir=str(tmp_path), device="cpu", resize=32)
    assert np.isfinite(res["loss"]) and res["ms_per_step"] > 0
    # the wrappers count kernel launches: their plain versions on the
    # host count none (on the card, 17 of each a step: chip_smoke.py)
    assert res["half_calls"] == {"nb_half_a": 0, "nb_half_a_bwd": 0,
                                 "nb_half_b": 0, "nb_half_b_bwd": 0}


def test_prof_feed_measures_six_ways(capsys):
    secs = prof_feed.run(bs=1, n=2, size=32, chain=2, device="cpu")
    assert set(prof_feed.MODES) <= set(secs)
    assert all(secs[m] > 0 for m in prof_feed.MODES)
    assert secs["batch_mb"] == 256 * 512 * 3 / 1e6
    line = prof_feed.report("put_sync", secs["put_sync"], 2, 1,
                            secs["batch_mb"])
    assert "MB/s" in line and "img/s" in line and "ms/batch" in line


# ----------------------------------------------------------------------
# the program's spans
# ----------------------------------------------------------------------

TRAIN_SPANS = ["train.step", "model.forward", "model.fit_loss",
               "train.backward", "train.optimizer"]
SERVE_SPANS = ["serve.call", "serve.h2d", "serve.backbone", "serve.heads",
               "serve.lanes"]


@pytest.fixture
def no_spans():
    reset_spans()
    yield
    reset_spans()


def _annotations(trace_dir):
    path = profiling._latest_trace_file(trace_dir)
    with gzip.open(path, "rt") as fh:
        events = json.load(fh)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def test_span_off_is_one_shared_noop(no_spans, monkeypatch):
    """With no profiler recording: one shared context, no CUDA event made,
    nothing recorded."""
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert not torch.autograd._profiler_enabled()
    off = span("a")
    assert off is span("b", "cpu", root=3)
    with off:
        with span("c"):
            pass
    assert span_records() == [] and span_summary() == {}


@pytest.mark.parametrize("call", ["train_step", "serve_call"])
def test_steps_record_nothing_without_a_profiler(call, no_spans):
    if call == "train_step":
        step, batch, gen = prof_train.setup(2, torch.device("cpu"), resize=32,
                                            packed_train=False)
        step(batch, gen)
    else:
        infer, images = prof_infer.setup(2, torch.device("cpu"), resize=64)
        infer(images)
    assert span_records() == []


def test_train_step_spans(tmp_path, no_spans):
    """One root `train.step` with the four phases under it in order, one
    root id (the step count before the step), the five ranges in the
    chrome trace; on the CPU no allocator counts."""
    step, batch, gen = prof_train.setup(2, torch.device("cpu"), resize=32)
    step(batch, gen)
    before = step.state.step
    with trace(str(tmp_path)) as t:
        step(batch, gen)
    recs = span_records()
    assert [r.name for r in recs] == TRAIN_SPANS
    root = recs[0]
    assert root.parent is None and root.root == before
    assert all(r.parent == root.index and r.root == before
               for r in recs[1:])
    assert all(r.host_ms > 0 and r.mallocs is None for r in recs)
    assert root.host_ms >= sum(r.host_ms for r in recs[1:])
    assert sorted(set(_annotations(t.dir)) & set(TRAIN_SPANS)) == sorted(
        TRAIN_SPANS)
    summary = span_summary()
    assert summary["train.backward"]["count"] == 1
    assert summary["train.step"]["mallocs"] is None
    assert summary["train.step"]["host_ms"] == pytest.approx(root.host_ms)
    host = summarize(t.dir, device_substr=CPU)
    assert {"model.forward", "train.backward"} <= {
        r.name for r in host.by_span}


def test_serve_call_spans(tmp_path, no_spans):
    """`serve.call` with the input copy, backbone, heads and lane
    projection under it; each call a root id of its own."""
    infer, images = prof_infer.setup(2, torch.device("cpu"), resize=64)
    with trace(str(tmp_path)) as t:
        infer(images)
        infer(images)
    recs = span_records()
    assert [r.name for r in recs] == SERVE_SPANS * 2
    first, second = recs[0], recs[5]
    assert second.root == first.root + 1
    for root, rs in ((first, recs[1:5]), (second, recs[6:])):
        assert root.parent is None
        assert all(r.parent == root.index and r.root == root.root
                   for r in rs)
    assert set(SERVE_SPANS) <= set(_annotations(t.dir))
    assert span_summary()["serve.heads"]["count"] == 2


def test_span_list_is_bounded(no_spans):
    extra = 10
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        for i in range(SPAN_LIMIT + extra):
            with span(f"s{i}"):
                pass
    recs = span_records()
    assert len(recs) == SPAN_LIMIT
    assert recs[0].name == f"s{extra}"
    assert recs[-1].name == f"s{SPAN_LIMIT + extra - 1}"
    assert [r.root for r in recs] == sorted({r.root for r in recs})


def _span_trace(path):
    def x(cat, name, tid, ts, dur, corr=None, pid=77):
        e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
             "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    ev = [
        # the host's spans: thread 1 runs the step, thread 2 is autograd's
        x("user_annotation", "train.step", 1, 0.0, 200.0),
        x("user_annotation", "model.forward", 1, 10.0, 50.0),
        x("user_annotation", "train.backward", 1, 100.0, 50.0),
        x("user_annotation", "Optimizer.step#Adam.step", 1, 160.0, 30.0),
        # launches
        x("cuda_runtime", "cudaLaunchKernel", 1, 20.0, 2.0, 1),
        x("cuda_runtime", "cudaLaunchKernel", 1, 30.0, 2.0, 2),
        x("cuda_runtime", "cudaMemcpyAsync", 1, 40.0, 2.0, 6),
        x("cuda_runtime", "cudaLaunchKernel", 2, 120.0, 2.0, 3),
        x("cuda_driver", "cuLaunchKernel", 1, 170.0, 2.0, 4),
        x("cuda_runtime", "cudaLaunchKernel", 1, 300.0, 2.0, 5),
        # the card: two kernels overlap by 10 us
        x("gpu_user_annotation", "model.forward", 7, 50.0, 49.0, pid=0),
        x("kernel", KERNEL_A, 7, 50.0, 30.0, 1, pid=0),
        x("kernel", KERNEL_B, 7, 70.0, 20.0, 2, pid=0),
        x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 8, 95.0, 4.0, 6,
          pid=0),
        x("kernel", KERNEL_C, 7, 130.0, 10.0, 3, pid=0),
        x("kernel", KERNEL_D, 7, 180.0, 5.0, 4, pid=0),
        x("kernel", KERNEL_A2, 7, 310.0, 2.0, 5, pid=0),
    ]
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": ev}, fh)


def test_by_span_and_busy(tmp_path):
    """Each device event goes to the innermost span open where its launch
    ran (autograd's thread: the span its caller waits in; PyTorch's own
    `#` ranges are no spans; a launch outside every span to OUTSIDE), and
    overlapping kernels count once in `busy_us`."""
    _span_trace(tmp_path / "0001.trace.json.gz")
    s = summarize(str(tmp_path), iters=2)
    assert s.total_us == 30.0 + 20.0 + 4.0 + 10.0 + 5.0 + 2.0
    assert s.busy_us == 40.0 + 4.0 + 10.0 + 5.0 + 2.0
    assert {r.name: (r.busy_us, r.kernels) for r in s.by_span} == {
        "model.forward": (44.0, 2), "train.backward": (10.0, 1),
        "train.step": (5.0, 1), OUTSIDE: (2.0, 1)}
    assert s.by_span[0].name == "model.forward"
    text = s.format()
    assert text.splitlines()[0] == (
        "device busy 30 us/iter (union of device intervals)")
    assert "       22.0       1.0  model.forward" in text
