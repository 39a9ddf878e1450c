"""The trace reduction on a hand-written chrome trace: overlapping
kernels (a programmatic dependent launch starts before the kernel ahead
of it ends) count once, the idle share, the gaps named by the host op
running through them, the kernel count."""

from __future__ import annotations

import pytest

from portbench import trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev(trace.WINDOW, "user_annotation", 100.0, 100.0),          # 100..200
    ev("aten::conv", "cpu_op", 95.0, 30.0),                      # 95..125
    ev("aten::copy_", "cpu_op", 160.0, 30.0),                    # 160..190
    ev("cudaLaunchKernel", "cuda_runtime", 162.0, 5.0),          # 162..167
    ev("void conv3tap_f32_kernel<64, 1>(float const*)", "kernel",
       110.0, 20.0),                                             # 110..130
    ev("void (anonymous namespace)::fold_rows_kernel<2>(int)", "kernel",
       125.0, 15.0),                                             # 125..140
    ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 150.0, 5.0),
    ev("void conv3tap_f32_kernel<128, 0>(float const*)", "kernel",
       185.0, 30.0),                                             # 185..215
    ev("before the window", "kernel", 10.0, 20.0),
    {"ph": "i", "name": "instant", "cat": "kernel", "ts": 120.0},
]


def test_union_counts_overlap_once():
    total, merged = trace.union_length([(0, 10), (5, 12), (20, 25), (24, 30)])
    assert total == 22 and merged == [[0, 12], [20, 30]]


def test_reduce_window_busy_idle_and_gaps():
    st = trace.reduce(EVENTS)
    assert st.window_s == pytest.approx(100e-6)
    # 110..140 (two kernels overlapping), 150..155, 185..200 (clipped)
    assert st.busy_s == pytest.approx(50e-6)
    assert st.kernels == 3
    assert dict(st.device_ops) == pytest.approx(
        {"conv3tap_f32_kernel": 35e-6, "fold_rows_kernel": 15e-6,
         "Memcpy HtoD": 5e-6})
    # gaps: 100..110 under aten::conv, 140..150 none, 155..185 the copy
    # (the launch inside it ends before the gap's midpoint 170)
    assert dict(st.idle_gaps) == pytest.approx(
        {"aten::conv": 10e-6, "host: no traced op": 10e-6,
         "aten::copy_": 30e-6})
    idle = 1.0 - st.busy_s / st.window_s
    assert idle == pytest.approx(0.5)


def test_innermost_host_op_names_the_gap():
    host = [(0.0, 100.0, "outer"), (10.0, 50.0, "inner"),
            (60.0, 70.0, "later")]
    assert trace.name_gaps([(20.0, 30.0), (52.0, 58.0), (61.0, 69.0),
                            (150.0, 160.0)], host) == [
        "inner", "outer", "later", "host: no traced op"]


def test_category_strips_templates_and_namespaces():
    assert trace.category(
        "void (anonymous namespace)::dyv_kernel<float, 64>(float const*)"
    ) == "dyv_kernel"
    assert trace.category("fusion.12.3") == "fusion"


def test_no_window_is_an_error():
    with pytest.raises(ValueError):
        trace.reduce(EVENTS[1:])


def test_device_idle_reads_the_untraced_window():
    """The card's busy time a traced step, over the untraced window's
    seconds a step; nothing without a trace."""
    import types

    from portbench import harness
    stats = trace.TraceStats(window_s=2.0, busy_s=1.2, kernels=10,
                             device_ops=[], idle_gaps=[])
    run = types.SimpleNamespace(trace=stats, traced_units=6, units=50,
                                seconds=10.5, family="train")
    reader, family = harness.metric_reader("device_idle.train")
    assert family == "train"
    assert reader.read(run) == pytest.approx(100.0 * (1.0 - 0.2 * 50 / 10.5))
    run.trace = None
    assert reader.read(run) is None
