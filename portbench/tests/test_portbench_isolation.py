"""Nothing a run imports is JAX, jaxlib, flax or the JAX package, compared
by the whole top-level name (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench import harness

PORT = "lanedetection_end2end_tpu_torch"


def _top_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    files = [p for p in harness.BENCH.rglob("*.py")]
    assert len(files) > 20
    for p in files:
        assert not set(_top_imports(p)) & set(harness.FORBIDDEN), p
    for p in (harness.BENCH / "reference").rglob("*.py"):
        assert PORT not in set(_top_imports(p)), p


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + "_fake", sys)
    assert harness.forbidden_modules() == [] or PORT not in \
        harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lanedetection_end2end_tpu.x", sys)
    assert "lanedetection_end2end_tpu" in harness.forbidden_modules()


SCRIPT = """
import sys, time
sys.path.insert(0, {root!r})
from portbench.tests.conftest import SMALL, small_copy
from portbench import harness
import pathlib, torch
torch.set_num_threads(1)
cell = "bp_train_sh.serve_b128"
bench, d = small_copy(pathlib.Path({tmp!r}), {{cell: SMALL[cell]}})
harness.run(cell, 5, 0.3, False, "cpu", time.perf_counter(), bench=bench,
            bench_dir=d)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_run_loads_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(
        root=str(harness.ROOT), tmp=str(tmp_path))], capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert PORT in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            "import portbench.reference.check, portbench.reference.model\n"
            "import portbench.reference.geometry\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (set(harness.FORBIDDEN) | {PORT})


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax",
                                  "lanedetection_end2end_tpu"])
def test_each_forbidden_name_is_caught(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, sys)
    assert name in harness.forbidden_modules()
