"""The learned-homography configuration (`bp_learned_h`) and the BEV
serving cell (`bev_egolane.serve_b128`): found by name, their work counts
against hand counts, their runs free of JAX, the sound program correct
and each control and fault that a cell can have not correct, on the CPU
at a small size."""

from __future__ import annotations

import contextlib
import subprocess
import sys
import types

import pytest
import torch
import torch.nn.functional as F

from portbench import faults, harness, inputs
from portbench.reference import check, geometry, model
from portbench.reference import homography as refhom
from portbench.tests.conftest import SEED, small_copy
from portbench.work import erfnet, homography

LH, BEVS = "bp_learned_h.train_b128", "bev_egolane.serve_b128"
SMALL = {LH: (32, 4), BEVS: (64, 4)}
BP = dict(profile="bp", resize=256, out_channels=4, order=3, clas=True,
          activation="square", mask_percentage=0.2, reg_ls=1.0,
          no_mapping=False, loss_policy="backproject", weight_fit=1.0,
          weight_class=1.0)


@pytest.fixture
def small(tmp_path):
    torch.set_num_threads(1)
    return small_copy(tmp_path, SMALL)


def run(small, cell, overrides=None):
    bench, bench_dir = small
    return harness.run(cell, SEED, 0.3, False, "cpu", 0.0, bench=bench,
                       overrides=overrides, bench_dir=bench_dir)


def test_new_pieces_are_found_by_name():
    bench = harness.read_json(harness.ROOT / "BENCHMARK.json")
    lh, bevs = harness.Cell(LH, bench), harness.Cell(BEVS, bench)
    assert lh.config["name"] == "bp_learned_h"
    assert lh.model["learn_homography"] is True
    assert lh.config["preset_kwargs"]["packed_train"] is True
    assert lh.traffic["kind"] == "train_closed_lh"
    assert set(lh.limits) == {"loss_gap", "grad_gap", "change_gap",
                              "M_gap", "head_grad_gap"}
    assert bevs.config["name"] == "bev_egolane"
    assert bevs.traffic["kind"] == "serve_closed_beta"
    assert set(bevs.limits) == {"fit_shift"}
    for kind in ("train_closed_lh", "serve_closed_beta"):
        assert hasattr(harness.load_plugin("traffic", kind), "Session")
    reader, family = harness.metric_reader("homography_host_ms.train")
    assert family == "train" and reader.__file__.endswith(
        "metrics/homography_host_ms.py")
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    assert per_layer["homography_host_ms.train"]["workloads"] == [LH]
    assert {m["name"] for m in lh.metrics(True)} >= {
        "homography_host_ms.train", "mfu.train", "kernels_per_step.train"}
    assert {m["name"] for m in bevs.metrics(False)} == {
        "setup_s", "serve_img_per_s"}
    # the other cells' traffic is the same as their siblings'
    for cell, twin in ((LH, "bp_train_sh.train_b128"),
                       (BEVS, "bp_train_sh.serve_b128")):
        a, b = (harness.Cell(c, bench).traffic for c in (cell, twin))
        assert {k: v for k, v in a.items() if k != "kind"} == {
            k: v for k, v in b.items() if k != "kind"}


def test_head_work_against_hand_counts():
    """Each convolution's taps that land on the plane, counted by running
    its geometry on ones; the full 3x3 grid (the zero padding counted)
    gives 67.1 M, 604.0 M, 302.0 M and 37.7 M FLOPs a frame at 256x512."""
    ls = {L.name.split(".")[-1]: L for L in homography.layers(BP)}
    full = {}
    for name, (cin, cout, k, h, w) in {
            "conv1": (128, 128, 1, 32, 64), "conv2": (128, 128, 3, 32, 64),
            "conv3": (128, 64, 3, 32, 64), "conv4": (64, 64, 3, 16, 32)
    }.items():
        ones = torch.ones(1, 1, h, w, dtype=torch.float64)
        hits = int(F.conv2d(ones, torch.ones(1, 1, k, k,
                                             dtype=torch.float64),
                            padding=k // 2).sum())
        L = ls[name]
        assert (L.cin, L.cout, L.taps) == (cin, cout, hits), name
        assert L.flops(1) == 2 * cin * cout * hits
        assert L.x == cin * h * w and L.y == cout * h * w
        full[name] = 2 * cin * cout * k * k * h * w
    assert [round(v / 1e6, 1) for v in full.values()] == [
        67.1, 604.0, 302.0, 37.7]
    assert ls["fc1"].flops(1) == 2 * 64 * 128
    assert ls["fc_offsets"].flops(1) == 2 * 128 * 3
    assert sum(L.flops(1) for L in ls.values()) == 980_402_944
    ops = homography.train_ops(BP, 2)
    assert len(ops) == 3 * len(ls)
    assert sum(o.flops for o in ops) == 3 * 2 * 980_402_944
    conv1 = ops[0]
    assert conv1.bytes == 4 * (2 * 128 * 32 * 64 * 2 + 128 * 128 + 128)


def test_the_session_counts_the_head(small):
    """The learned-homography session's work is the backbone's and the
    other heads' (`erfnet.train_ops`) and the head's."""
    bench, bench_dir = small
    kind = harness.load_plugin("traffic", "train_closed_lh", bench_dir)
    cell = harness.Cell(LH, bench, bench_dir)
    fake = types.SimpleNamespace(ctx=types.SimpleNamespace(model=cell.model),
                                 B=3, dtype="float32")
    ops = kind.Session.ops(fake)
    assert ops == (erfnet.train_ops(cell.model, 3)
                   + homography.train_ops(cell.model, 3))


def test_homography_host_ms_reads_the_traced_steps():
    from lanedetection_end2end_tpu_torch.utils import profiling
    reader = harness.metric_reader("homography_host_ms.train")[0]
    Rec = profiling.SpanRecord
    ms = 1_000_000
    recs = [Rec(0, "train.step", None, 0, 0, 50 * ms),
            Rec(1, "model.homography", 0, 0, 0, 9 * ms),
            Rec(2, "train.step", None, 1, 0, 50 * ms),
            Rec(3, "model.homography", 2, 1, 0, 2 * ms),
            Rec(4, "train.step", None, 2, 0, 50 * ms),
            Rec(5, "model.homography", 4, 2, 0, 4 * ms)]
    run_ = types.SimpleNamespace(trace=object(), traced_units=2)
    orig = profiling.span_records
    try:
        profiling.span_records = lambda: recs
        assert reader.read(run_) == pytest.approx(3.0)
        profiling.span_records = lambda: recs[::2]
        assert reader.read(run_) is None
    finally:
        profiling.span_records = orig
    assert reader.read(types.SimpleNamespace(trace=None,
                                             traced_units=2)) is None


def test_reference_dlt_at_zero_offsets_is_the_fixed_matrix():
    M, M_inv = refhom.dlt(torch.zeros(2, 3), 64)
    want, want_inv = geometry.matrices("bp", 64)
    assert torch.allclose(M.double(), torch.from_numpy(want).expand(
        2, 3, 3), rtol=1e-6, atol=1e-6)
    assert torch.allclose(M_inv.double(), torch.from_numpy(
        want_inv / want_inv[2, 2]).expand(2, 3, 3), rtol=1e-5, atol=1e-5)
    ref = refhom.LearnedModel(dict(BP, resize=64), "cpu")
    plain = model.Model(dict(BP, resize=64), "cpu")
    rows = ref.coeff_rows(M)
    assert torch.allclose(rows[0], plain.coeff, rtol=1e-5, atol=1e-5)


def test_reference_state_extends_the_bp_state():
    spec, base = refhom.state_spec(BP), model.state_spec(BP)
    assert list(spec)[:len(base)] == list(base)
    head = [k for k in spec if k.startswith("homography_head.")]
    assert len(head) == len(spec) - len(base) == 32
    assert spec["homography_head.conv2.weight"] == ((128, 128, 3, 3),
                                                    "weight", 1152)
    assert spec["homography_head.conv2_bn.weight"][1] == "bn_weight"
    assert spec["homography_head.fc_offsets.weight"][2] == 128


@pytest.mark.parametrize("cell", [LH, BEVS])
def test_sound_program_is_correct(small, cell):
    res = run(small, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@contextlib.contextmanager
def detached(route):
    """The learned homography's matrices detached where the fit
    ("fit") or the loss ("loss") takes them."""
    from lanedetection_end2end_tpu_torch.ops.losses import (
        BackprojectionLoss)
    from lanedetection_end2end_tpu_torch.ops.wls import WLSFitter
    cls, name, cut = {"fit": (WLSFitter, "sep_coeff_from_M", (0,)),
                      "loss": (BackprojectionLoss, "with_M", (3, 4))}[route]
    orig = getattr(cls, name)

    def cut_args(self, *args):
        return orig(self, *(a.detach() if i in cut else a
                            for i, a in enumerate(args)))
    setattr(cls, name, cut_args)
    try:
        yield
    finally:
        setattr(cls, name, orig)


@contextlib.contextmanager
def bev_fp8_control():
    """The engine replaced by the reference one precision below each
    stage the configuration states: float8 convolutions, the fit's
    moments on bfloat16 operands."""
    from lanedetection_end2end_tpu_torch.models import infer_engine as ie
    cls = ie.FusedLaneNetEngine
    prep, call = cls.prepare, cls.__call__

    def prepare(self, state):
        self.ref_state = {k: v.detach().clone() for k, v in state.items()}
        self.ref = model.Model(faults._model_of(self.cfg), self.device,
                               round_tail=check.bf16)
        return prep(self, state)

    def __call__(self, packed, images):
        with check.exact_float32(), torch.no_grad(), \
                check.rounded(check.fp8_e4m3):
            out = self.ref.forward(self.ref_state, images.float(), False)
        return out["beta"], None, None
    cls.prepare, cls.__call__ = prepare, __call__
    try:
        yield
    finally:
        cls.prepare, cls.__call__ = prep, call


@pytest.mark.parametrize("plant", ["bf16", "fit", "loss", "unchanged",
                                   "half", "altered"])
def test_each_learned_h_control_and_fault_is_caught(small, plant):
    if plant == "bf16":
        res = run(small, LH, overrides={"compute_dtype": "bfloat16"})
    else:
        ctx = (detached(plant) if plant in ("fit", "loss")
               else faults.TRAIN[plant]())
        with ctx:
            res = run(small, LH)
    assert not res["correct"], res["checks"]
    if plant in ("fit", "loss"):  # the head's own gradient shows it
        assert res["checks"]["head_grad_gap"]["value"] > res["checks"][
            "head_grad_gap"]["limit"]


@pytest.mark.parametrize("plant", ["control", "half"])
def test_each_bev_serving_control_and_fault_is_caught(small, plant):
    with (bev_fp8_control() if plant == "control"
          else faults.SERVE["half"]()):
        res = run(small, BEVS)
    assert not res["correct"], res["checks"]


SCRIPT = """
import sys, time
sys.path.insert(0, {root!r})
from portbench.tests.test_portbench_new_cells import SMALL
from portbench.tests.conftest import small_copy
from portbench import harness
import pathlib, torch
torch.set_num_threads(1)
bench, d = small_copy(pathlib.Path({tmp!r}), SMALL)
for cell in SMALL:
    harness.run(cell, 5, 0.3, True, "cpu", time.perf_counter(), bench=bench,
                bench_dir=d)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_runs_of_the_new_cells_load_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(
        root=str(harness.ROOT), tmp=str(tmp_path))], capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "lanedetection_end2end_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_of_the_head_loads_nothing_of_the_program():
    code = ("import sys\n"
            "import portbench.reference.homography\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (set(harness.FORBIDDEN)
                         | {"lanedetection_end2end_tpu_torch"})
    state = inputs.make_state(refhom.state_spec(dict(BP, resize=32)), 1,
                              "cpu")
    assert "homography_head.fc_offsets.bias" in state
