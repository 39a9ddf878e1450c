"""The JAX package's native resampler under several test workers, and the
helper every port test that decodes images through JAX calls first.

JAX's `data/native.py` builds `native/liblaneops.so` with g++ in place on
first use (the file is not in a fresh checkout), turns any load error
into "unavailable" for the life of the process without retrying, and
`data/dataset.py` then decodes with PIL, within 1/255 of the native
resampler. Under pytest-xdist several workers build and load the file at
once, and one that opens it half written decodes every image with PIL
from then on. The port has one resampler, its native one, so its images,
and every loss on them, differ from that worker's JAX images: the BEV
Trainer tests read a validation loss 5.9e-4 off against their 1e-4 bar.

`require_jax_native()` takes a file lock, and where JAX's library did not
load, resets JAX's memo and loads again, for up to a minute, while
another worker may still be writing the file; then it asserts that JAX's
native library is loaded. The JAX package is not changed.
"""

import fcntl
import os
import shutil
import tempfile
import time

import jax
import numpy as np
import torch

from lanedetection_end2end_tpu.config import train_sh_config as jax_cfg
from lanedetection_end2end_tpu.data import dataset as jax_dataset
from lanedetection_end2end_tpu.data import native as jax_native
from lanedetection_end2end_tpu.models import LaneNet as JaxLaneNet
from lanedetection_end2end_tpu.train import steps as jsteps
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.data import dataset
from lanedetection_end2end_tpu_torch.data.loader import collate
from lanedetection_end2end_tpu_torch.data.synthetic import make_synthetic_root
from lanedetection_end2end_tpu_torch.models.init import init_weights
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.models.port import (
    variables_from_state_dict)
from lanedetection_end2end_tpu_torch.train.steps import make_eval_step
from test_torch_threads import one_torch_thread  # noqa: F401

RESIZE = 32
_LOCK = os.path.join(tempfile.gettempdir(), "ld_jax_native.lock")


def require_jax_native(timeout: float = 60.0) -> None:
    """Make sure JAX's native resampler is loaded in this process, so its
    `LaneDataset` decodes as the port's does: under a file lock shared by
    the test workers, reload it (resetting JAX's one-shot memo) until it
    loads or `timeout` seconds pass, then assert that it is loaded."""
    with open(_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            deadline = time.monotonic() + timeout
            while not jax_native.available() and time.monotonic() < deadline:
                time.sleep(0.5)
                jax_native._tried, jax_native._lib = False, None
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    assert jax_native.available(), (
        f"JAX's native resampler {jax_native._LIB_PATH} does not load: its "
        "LaneDataset would decode with PIL, off the port's images")


def _items(pkg, root, n=2):
    ds = pkg.LaneDataset("bp", root["image_dir"], root["gt_dir"],
                         valid_idx=list(range(n)), resize=RESIZE, nclasses=4,
                         lanes_file=root["lanes_file"],
                         line_file=root["line_file"], image_dtype="uint8")
    return collate([ds[i] for i in range(n)])


def test_a_torn_library_sends_jax_to_pil_until_the_helper_reloads(
        tmp_path, monkeypatch):
    """A worker that loads the library while another is writing it: JAX
    reads "unavailable", decodes with PIL, and its validation loss on the
    port's weights leaves the port's by more than the Trainer tests' 1e-4
    bar. Once the file is whole JAX's own loader still says no for the
    life of the process; the helper loads it, and the losses agree."""
    require_jax_native()
    whole = open(jax_native._LIB_PATH, "rb").read()
    src, lib = tmp_path / "laneops.cpp", tmp_path / "liblaneops.so"
    shutil.copyfile(jax_native._SRC, src)
    lib.write_bytes(whole[:32])                 # the linker has just begun
    os.utime(src, (1, 1))                       # older: JAX will not rebuild
    monkeypatch.setattr(jax_native, "_SRC", str(src))
    monkeypatch.setattr(jax_native, "_LIB_PATH", str(lib))
    monkeypatch.setattr(jax_native, "_tried", False)
    monkeypatch.setattr(jax_native, "_lib", None)
    assert not jax_native.available()

    root = make_synthetic_root(str(tmp_path / "data"), num_train=2,
                               num_test=0, seed=4)
    port_batch = _items(dataset, root)
    pil_batch = _items(jax_dataset, root)
    assert np.abs(pil_batch["image"].astype(int)
                  - port_batch["image"].astype(int)).max() >= 1

    cfg = train_sh_config(resize=RESIZE, batch_size=2, reg_ls=1.0)
    net = LaneNet(cfg, device="cpu")
    init_weights(net, "kaiming", torch.Generator().manual_seed(0))
    v = variables_from_state_dict(net.state_dict(), RESIZE)
    jcfg = jax_cfg(resize=RESIZE, batch_size=2, reg_ls=1.0)
    jloss = jax.jit(jsteps.make_loss_fn(JaxLaneNet(jcfg), jcfg, "e2e",
                                        train=False, use_packed=False))

    def jax_loss(batch):
        metrics = jloss(v["params"], v["batch_stats"], batch, None)[1][0]
        return float(metrics["loss"])

    port_loss = float(make_eval_step(net, cfg, device="cpu")(
        {k: torch.from_numpy(a) for k, a in port_batch.items()})[0]["loss"])
    rel = abs(jax_loss(pil_batch) - port_loss) / abs(port_loss)
    assert rel > 1e-4, rel

    lib.write_bytes(whole)                      # the writer finishes
    assert not jax_native.available()           # JAX never tries again
    require_jax_native()
    native_batch = _items(jax_dataset, root)
    for k in port_batch:
        np.testing.assert_array_equal(native_batch[k], port_batch[k], k)
    rel = abs(jax_loss(native_batch) - port_loss) / abs(port_loss)
    assert rel < 1e-4, rel
