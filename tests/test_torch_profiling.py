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
measures what it names."""

import gzip
import json

import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu_torch.tools import (
    prof_feed, prof_infer, prof_train)
from lanedetection_end2end_tpu_torch.utils.profiling import (
    CPU, category, summarize, trace)
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
    assert text.splitlines()[0] == "total device op time 50 us/iter"
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
