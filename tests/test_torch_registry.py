"""The port's backbone registry and public exports against the JAX
package's: `define_model` / `MODEL_REGISTRY` as tests/test_models.py holds
JAX's (the default out_channels, KeyError with the list for an unknown
name), the built ERFNet's forward in its compute dtype, and every name
the JAX package's `__init__.py` files export, found in the port's package
of the same place under the same name, or under the port's own name in
the listed pairs."""

import importlib
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lanedetection_end2end_tpu as jax_pkg
import lanedetection_end2end_tpu_torch as pkg
from lanedetection_end2end_tpu.models.registry import (
    define_model as jax_define_model)
from lanedetection_end2end_tpu_torch.models import (
    MODEL_REGISTRY, define_model)
from lanedetection_end2end_tpu_torch.models.erfnet import ERFNet
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SUBPACKAGES = ("", "models", "ops", "data", "eval", "train", "geometry",
               "parallel", "utils")
# JAX's name -> the port's, where the JAX name means nothing in the port
PAIRS = {
    "port_torch_state_dict": "state_dict_from_variables",
    "load_into_variables": "variables_from_state_dict",
    "nb1d_fused": "nb1d",
    "make_mesh": "DataParallel",
    "make_mesh_2d": "init_data_parallel",
    "data_axes": "local_rows",
    "batch_sharding": "local_rows",
    "replicated_sharding": "replicate",
    "shard_batch": "local_rows",
}
# the pairs whose port name lives in a module, not in the package where
# JAX exports it: (subpackage, JAX name) -> module path
IN_MODULE = {("ops", "nb1d_fused"): "lanedetection_end2end_tpu_torch.ops.nb1d"}


def test_registry():
    assert define_model("erfnet").out_channels == 2
    assert jax_define_model("erfnet").out_channels == 2
    with pytest.raises(KeyError, match="available: \\['erfnet'\\]"):
        define_model("resnet999")
    with pytest.raises(KeyError):
        jax_define_model("resnet999")
    assert set(MODEL_REGISTRY) == {"erfnet"}


def test_define_model_builds_the_port_erfnet():
    net = define_model("erfnet", in_channels=3, out_channels=5,
                       pretrained=True)
    assert isinstance(net, ERFNet)
    assert net.decoder.output_conv.out_channels == 5
    assert net.decoder.output_conv2.out_channels == 6
    assert set(net.state_dict()) == set(ERFNet(5, True).state_dict())


def test_define_model_runs_in_its_compute_dtype():
    """bf16: the forward's activations in bf16, the parameters float32,
    the same function as the float32 ERFNet run through `call_in_dtype`;
    float32: the module as built."""
    torch.manual_seed(0)
    net = define_model("erfnet", out_channels=4, dtype=torch.bfloat16)
    ref = ERFNet(4)
    ref.load_state_dict(net.state_dict())
    x = torch.rand(1, 3, 32, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        enc, dec, _ = net.eval()(x)
        from lanedetection_end2end_tpu_torch.models.erfnet import (
            call_in_dtype)
        want = call_in_dtype(ref.eval(), torch.bfloat16, x)[1]
        f32 = ref(x)[1]
    assert enc.dtype == dec.dtype == torch.bfloat16
    assert {p.dtype for p in net.parameters()} == {torch.float32}
    assert torch.equal(dec, want)
    assert not torch.equal(dec.float(), f32)
    assert define_model("erfnet").compute_dtype == torch.float32


def _exports(module):
    """The names a package's `__init__.py` exports: not its submodules."""
    return {k for k, v in vars(module).items()
            if not k.startswith("_") and not inspect.ismodule(v)}


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=[s or "root"
                                                  for s in SUBPACKAGES])
def test_exports_match_jax(sub):
    jmod = importlib.import_module(
        "lanedetection_end2end_tpu" + (f".{sub}" if sub else ""))
    tmod = importlib.import_module(
        "lanedetection_end2end_tpu_torch" + (f".{sub}" if sub else ""))
    missing = []
    for name in sorted(_exports(jmod)):
        port_name = PAIRS.get(name, name)
        where = IN_MODULE.get((sub, name))
        holder = importlib.import_module(where) if where else tmod
        if not hasattr(holder, port_name):
            missing.append(f"{name} -> {port_name}")
    assert not missing, missing


def test_pairs_are_the_ports_counterparts():
    """Each pair's port name is what the port's own docs name as the
    counterpart: the weight carrier's two directions are inverses."""
    from lanedetection_end2end_tpu_torch.config import train_sh_config
    from lanedetection_end2end_tpu_torch import models
    net = pkg.LaneNet(train_sh_config(resize=32), device="cpu")
    sd = net.state_dict()
    back = models.state_dict_from_variables(
        models.variables_from_state_dict(sd, 32), profile="bp")
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(np.asarray(back[k]), sd[k].numpy(),
                                      err_msg=k)
    assert pkg.__version__ == jax_pkg.__version__


def test_package_import_builds_nothing_and_imports_no_jax():
    code = (
        "import sys\n"
        "for n in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'lanedetection_end2end_tpu'):\n"
        "    sys.modules[n] = None\n"
        "import lanedetection_end2end_tpu_torch as p\n"
        "from lanedetection_end2end_tpu_torch import (models, ops, data,"
        " eval, train)\n"
        "from lanedetection_end2end_tpu_torch.ops import _build\n"
        "assert _build._library.cache_info().currsize == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(dir(p)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) > 20
