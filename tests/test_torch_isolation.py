"""The PyTorch port stands alone: it imports without JAX, flax or the JAX
package, its sources import none of them, and without a card its entry
points refuse to run unless the caller asks for the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "lanedetection_end2end_tpu_torch"

_IMPORT_ALL = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "lanedetection_end2end_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib, pkgutil
import lanedetection_end2end_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax")
       and sys.modules[m] is not None]
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 45  # every module was imported


_MAIN_WITHOUT_JAX = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "lanedetection_end2end_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import main_torch
from lanedetection_end2end_tpu_torch.data import (
    dataset, labels, loader, native, synthetic)
from lanedetection_end2end_tpu_torch.eval import (
    lane_eval, projections, test_driver)
from lanedetection_end2end_tpu_torch.models import init
from lanedetection_end2end_tpu_torch.train import (
    checkpoint, driver, visualize)
from lanedetection_end2end_tpu_torch.utils import observability
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""


def test_main_torch_and_the_trainer_modules_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _MAIN_WITHOUT_JAX],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "ok"


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax"
    r"|lanedetection_end2end_tpu(?!_torch))\b", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "main_torch.py"]))
def test_source_imports_nothing_of_jax(path):
    assert not _FORBIDDEN.findall((ROOT / path).read_text()), path


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from lanedetection_end2end_tpu_torch.config import train_sh_config
    from lanedetection_end2end_tpu_torch.models.infer_engine import (
        FusedLaneNetEngine)
    from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
    from lanedetection_end2end_tpu_torch.train.optim import define_optim
    from lanedetection_end2end_tpu_torch.train.steps import (
        make_eval_step, make_train_step)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = train_sh_config(resize=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedLaneNetEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LaneNet(cfg)
    assert FusedLaneNetEngine(cfg, device="cpu").device.type == "cpu"
    net = LaneNet(cfg, device="cpu")
    opt = define_optim(net.parameters(), "adam", 1e-4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(net, cfg, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(net, cfg)
    assert make_train_step(net, cfg, opt, device="cpu").state.step == 0
    from lanedetection_end2end_tpu_torch.train.driver import Trainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, log_to_file=False, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg.torch_device()
    assert cfg.replace(no_cuda=True).torch_device().type == "cpu"


def test_fitter_and_loss_default_to_the_card(monkeypatch):
    """`WLSFitter` and `BackprojectionLoss` hold their constants on the
    card unless asked for the CPU: without one they raise."""
    import numpy as np

    from lanedetection_end2end_tpu_torch.ops.losses import BackprojectionLoss
    from lanedetection_end2end_tpu_torch.ops.wls import WLSFitter
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WLSFitter(np.eye(3), 8, 16, 2, normalized=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BackprojectionLoss(64, 3)
    assert WLSFitter(np.eye(3), 8, 16, 2, normalized=False,
                     device="cpu").sep_coeff.device.type == "cpu"
    assert BackprojectionLoss(64, 3, device="cpu").Y.device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    from lanedetection_end2end_tpu_torch.ops.nb1d import nb1d
    x = torch.zeros(1, 2, 2, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        nb1d(x, {"w": x, "vec": x, "dilation": 1})


def test_check_cuda_takes_float32_planes_and_refuses_a_mismatch():
    """The kernels take bf16 and float32 planes: a float32 plane on the
    card passes `check_cuda(t, torch.float32)`, and a dtype other than the
    one asked for still raises (it never takes the plain version)."""
    from lanedetection_end2end_tpu_torch.ops import _build

    class OnCard:  # stands in for a CUDA tensor: this host has no card
        device = torch.device("cuda", 0)
        dtype = torch.float32
        shape = (2, 4, 4, 16)

        def is_contiguous(self):
            return True

        def data_ptr(self):
            return 4096

    assert _build.check_cuda(OnCard(), torch.float32, (2, 4, 4, 16),
                             "x") == 4096
    with pytest.raises(TypeError, match="expected torch.bfloat16, got "
                                        "torch.float32"):
        _build.check_cuda(OnCard(), torch.bfloat16, name="x")
