"""The reader of the program's root spans (`metrics/cuda_mallocs.py`): it
takes the last `traced_units` root spans of
`utils/profiling.py::span_records()` and averages their `cudaMalloc`
counts, ignoring the profiled warm-up roots before them; it reads nothing
on the CPU or from a program without spans. The new entries keep the
contract of the discovery test, and a small traced run on the CPU records
the spans and reports none of them."""

from __future__ import annotations

import types

import pytest

from lanedetection_end2end_tpu_torch.utils import profiling
from portbench import harness
from portbench.tests.conftest import run_small

ROOTS = {"train": "train.step", "serve": "serve.call"}
NEW = ["cuda_mallocs.train", "cuda_mallocs.serve"]


def records(root, device=True):
    """Two warm-up roots, then three traced ones, each with two children;
    the roots' cudaMalloc counts (None on the CPU); a root of another name
    and one still open last."""
    recs, i = [], 0

    def rec(name, parent, r, mallocs=None, end=1000):
        nonlocal i
        i += 1
        return profiling.SpanRecord(i, name, parent, r, 0, end,
                                    mallocs if device else None)
    for r, mallocs in enumerate([50, 60, 3, 5, 7]):  # 2 warm, 3 traced
        top = rec(root, None, r, mallocs)
        recs += [top, rec("a.phase", top.index, r),
                 rec("b.phase", top.index, r)]
    recs += [rec("other.root", None, 5, 90), rec(root, None, 6, 90, None)]
    return recs


def traced_run(family, units=3):
    return types.SimpleNamespace(family=family, traced_units=units,
                                 trace=object())


def read(name, run):
    reader, family = harness.metric_reader(name)
    assert family == run.family
    return reader.read(run)


@pytest.mark.parametrize("family", ["train", "serve"])
def test_malloc_reader_means_the_traced_roots(family, monkeypatch):
    recs = records(ROOTS[family])
    monkeypatch.setattr(profiling, "span_records", lambda: recs)
    assert read(f"cuda_mallocs.{family}", traced_run(family)) == (
        pytest.approx((3 + 5 + 7) / 3))


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_without_device_spans(name, monkeypatch):
    family = name.rsplit(".", 1)[1]
    recs = records(ROOTS[family], device=False)
    monkeypatch.setattr(profiling, "span_records", lambda: recs)
    assert read(name, traced_run(family)) is None          # the CPU
    monkeypatch.setattr(profiling, "span_records", lambda: [])
    assert read(name, traced_run(family)) is None          # no records
    run = traced_run(family)
    run.trace = None
    assert read(name, run) is None                         # not traced
    monkeypatch.delattr(profiling, "span_records")
    assert read(name, traced_run(family)) is None          # no spans


def test_new_entries_keep_the_contract():
    bench = harness.read_json(harness.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for name in NEW:
        m = entries[name]
        family = name.rsplit(".", 1)[1]
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert m["unit"] == {"train": "mallocs/step",
                             "serve": "mallocs/call"}[family]
        assert m["moves"] == f"{family}_img_per_s"
        assert set(m["workloads"]) == set(e2e[m["moves"]]["workloads"])
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert name in {x["name"] for x in
                            harness.Cell(cell, bench).metrics(True)}
        harness.metric_reader(name)
    assert {entries[n]["layer"] for n in NEW} == {"allocator"}


@pytest.mark.parametrize("cell", ["bp_train_sh.train_b128",
                                  "bp_train_sh.serve_b128"])
def test_a_traced_run_records_the_spans(cell, small):
    """On the CPU the traced stretch records the program's spans (host
    times, no allocator counts), and the run reports none of the new
    metrics."""
    profiling.reset_spans()
    res = run_small(small, cell, trace=True)
    family = harness.Cell(cell, small[0], small[1]).traffic["kind"].split("_")[0]
    assert not set(NEW) & set(res["metrics"])
    roots = [r for r in profiling.span_records()
             if r.parent is None and r.name == ROOTS[family]]
    w = harness.read_json(small[1] / "workloads" / f"{cell}.json")["traffic"]
    assert len(roots) == w["profile_warm"] + w.get(
        "profile_steps", w.get("profile_calls"))
    assert all(r.mallocs is None and r.host_ms > 0 for r in roots)
    profiling.reset_spans()
