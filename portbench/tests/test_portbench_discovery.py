"""Cells, configurations, traffic and metrics are found by name, a new
cell and a new metric come in as files alone, and the result object has
the keys its readers take, the checks last."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.conftest import SEED, run_small

TRAIN = ["bp_train_sh.train_b128", "bev_egolane.train_b128"]


def test_every_cell_resolves_its_files():
    bench = harness.read_json(harness.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert (harness.BENCH / "traffic"
                / f"{cell.traffic['kind']}.py").is_file()
        assert set(cell.limits) and cell.chips == w["chips"] == 1
        for m in cell.metrics(False) + cell.metrics(True):
            harness.metric_reader(m["name"])
        names = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in names and len(names) >= 2
        assert cell.metrics(True)
    for c in bench["configs"]:
        cfg = harness.read_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_unknown_names_are_refused():
    bench = harness.read_json(harness.ROOT / "BENCHMARK.json")
    with pytest.raises(KeyError):
        harness.Cell("no.such_cell", bench)
    with pytest.raises(FileNotFoundError):
        harness.load_plugin("metrics", "no_such_metric")
    with pytest.raises(FileNotFoundError):
        harness.metric_reader("no_such_metric.train")


def test_a_family_metric_is_read_by_its_base_file():
    """`mfu.train` and `mfu.serve` are both read by `metrics/mfu.py`, each in
    its own family's runs; a metric with a file of its own keeps it."""
    assert harness.metric_reader("mfu.train")[1] == "train"
    assert harness.metric_reader("mfu.serve")[1] == "serve"
    assert (harness.metric_reader("mfu.train")[0].__file__
            == str(harness.BENCH / "metrics" / "mfu.py"))
    assert harness.metric_reader("serve_p95_ms")[1] is None


def test_a_new_cell_and_metric_come_in_as_files(tmp_path, small):
    """A throwaway cell (the BP step at batch 2) and per-layer metric are
    added as files and entries only, and the harness reports them."""
    bench, bench_dir = small
    w = json.loads((bench_dir / "workloads"
                    / "bp_train_sh.train_b128.json").read_text())
    w["traffic"].update(batch=2, profile_warm=1, profile_steps=1)
    (bench_dir / "workloads" / "bp_train_sh.extra_b2.json").write_text(
        json.dumps(w))
    (bench_dir / "metrics" / "images_per_traced_step.x.py").write_text(
        "def read(run):\n"
        "    return run.batch if run.trace is not None else None\n")
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "bp_train_sh.extra_b2",
                               "config": "bp_train_sh", "traffic": "train_b2",
                               "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({
        "name": "images_per_traced_step.x", "unit": "images",
        "better": "higher", "source": "program_counter", "layer": "test",
        "moves": "train_img_per_s", "workloads": ["bp_train_sh.extra_b2"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_per_s":
            m["workloads"].append("bp_train_sh.extra_b2")
    res = run_small((bench, bench_dir), "bp_train_sh.extra_b2", trace=True)
    assert res["metrics"]["images_per_traced_step.x"] == {
        "value": 2, "unit": "images"}
    assert res["attempted"] > 0 and set(res["checks"]) == {
        "loss_gap", "grad_gap", "change_gap"}
    res = run_small((bench, bench_dir), "bp_train_sh.extra_b2")
    assert set(res["metrics"]) == {"setup_s", "train_img_per_s"}


def test_result_keys_and_checks_last(small):
    res = run_small(small, "bp_train_sh.serve_b128")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}
    assert set(res["metrics"]) == {"setup_s", "serve_img_per_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0
    json.dumps(res, allow_nan=False)


def _run_cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", TRAIN[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    """Here there is no card: the command fails and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_cli(harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_bare_directory_no_result(tmp_path):
    """BENCHMARK.json and the benchmark's files alone: no result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_cell_on_the_card():
    """On a card: a short run of the serving cell prints a correct result
    line."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "bp_train_sh.serve_b128", "--seed", str(SEED), "--seconds", "2",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
