"""The plain graph in bf16 (`LaneNet.forward(dtype=torch.bfloat16)`), the
port against the JAX package's `LaneNet(cfg, dtype=bfloat16)` on the CPU.

Weights: the port's kaiming init (the Trainer's scheme), carried to JAX
by `variables_from_state_dict`; there JAX's own bf16 graph lies
measurably off its float32 graph. Config `train_sh_config(resize=32)`,
batch 2, dropout off (flax's Dropout an identity for the call, as
tests/test_torch_phases.py does).

1. Layer by layer: every encoder and decoder layer, the segmentation
   head and the line, horizon and homography heads, each fed JAX's own
   bf16 input for it (flax's `capture_intermediates`), in eval and in
   train mode. The port's bf16 layer equals JAX's bit for bit on nearly
   every element: the rest are one- or two-ulp flips of bf16 roundings
   where the two libraries sum a convolution (or, in train mode, a
   BatchNorm's moments) in another order. Read on these weights: at most
   0.3% of a layer's elements in eval mode and 10.5% in train mode (the
   first NB1D block), at most 5.5e-3 of max|y|. Bars: 1% / 20% of the
   elements and 2^-6 of max|y| (two bf16 ulps at the top of the range).
   The control, the port's float32 layer on the same input, differs on
   48% to 100% of the elements: it must differ on more than 40%.
2. Whole steps, one per plain-graph phase: skip and seg (the pretraining
   head), e2e with `packed_train=False`, e2e with the learned homography
   and `packed_train=False` (the port's default step trains that option
   on its packed path, which JAX's does not serve: its bf16 loss lies
   4.6% from JAX's flax bf16 loss here, beyond this module's bar of JAX's
   own bf16-vs-float32 gap, 1.7%, plus 2e-3, because the packed path
   takes the images in bf16 as JAX's packed path does; so
   tests/test_torch_learned_h_packed.py holds it against JAX's flax bf16
   step on these weights at tests/test_torch_train_step.py's bf16 bars
   for the packed step, and against the port's plain bf16 step); the port's
   `make_loss_fn` against JAX's flax `make_loss_fn(use_packed=False)` in
   bf16, every NB1D block's bn2
   scale times 0.1 as tests/test_torch_phases.py damps them. beta at
   3e-2 of max|beta| (ROADMAP Queue 3's bf16 parity limit; read 1.4e-3
   to 4.3e-3). The loss within JAX's own bf16-vs-float32 gap at that
   input plus 2e-3 of the loss (read 0.04 and 0.41 of the gap in the e2e
   steps; in skip and seg the gap is 1.2e-4 of the loss, at the noise of
   the bf16 logits, and the port sits about as far from JAX's bf16 loss
   as from its float32 one, 0.998 of the gap). The control for the
   dtype: the port's bf16 step departs from JAX's float32 step at least
   a quarter as far as JAX's bf16 step does (beta, and the loss in the
   e2e steps; read 0.33 to 1.51), and the port's float32 step, which runs
   the same code with `compute_dtype="float32"`, must stay under that
   quarter (read 0.003 to 0.010). As drawn
   (bn2 undamped) a train-mode step at this size amplifies those flips
   until the port's and JAX's bf16 beta lie as far apart as either lies
   from float32 (up to 7e-2 of max|beta|), so the whole steps are held
   on damped weights, the layers on the weights as drawn.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.config import train_sh_config as jax_config
from lanedetection_end2end_tpu.models import LaneNet as JaxLaneNet
from lanedetection_end2end_tpu.train import steps as jsteps
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.eval import test_driver
from lanedetection_end2end_tpu_torch.eval.projections import Projections
from lanedetection_end2end_tpu_torch.models.erfnet import call_in_dtype
from lanedetection_end2end_tpu_torch.models.init import init_weights
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.models.port import (
    variables_from_state_dict)
from lanedetection_end2end_tpu_torch.train import steps as tsteps
from lanedetection_end2end_tpu_torch.train.optim import define_optim
from test_torch_phases import _batch
from test_torch_threads import one_torch_thread  # noqa: F401

RESIZE, BATCH = 32, 2
BF16 = torch.bfloat16
BETA_BAR = 3e-2
ULP2 = 2.0 ** -6          # two bf16 ulps of max|y|
FLIPS = {"eval": 1e-2, "train": 0.2}
CONTROL_FLIPS = 0.4
QUARTER = 0.25
STEPS = {"skip": (dict(pretrained=True), "skip"),
         "seg": (dict(pretrained=True), "seg"),
         "e2e-plain": (dict(packed_train=False), "e2e"),
         "e2e-learned": (dict(learn_homography=True, packed_train=False),
                         "e2e")}


@pytest.fixture(autouse=True)
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)


def kaiming_lanenet(cfg, damp=1.0):
    """The port's LaneNet with kaiming weights (seed 0) and every bn2
    scale times `damp`."""
    net = LaneNet(cfg, device="cpu")
    init_weights(net, "kaiming", torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bn2.weight"):
                p.mul_(damp)
    return net


# ----------------------------------------------------------------------
# 1. layer by layer
# ----------------------------------------------------------------------

def _layers(net, inter, images):
    """[(name, port module, JAX's input, JAX's output)] in graph order."""
    out = lambda t: np.asarray(t["__call__"][0], np.float32)
    enc_i = inter["erfnet"]["encoder"]
    dec_i = inter["erfnet"]["decoder"]
    names = (["down1"] + [f"nb64_{i}" for i in range(5)] + ["down2"]
             + [f"nb128_{j}_d{d}" for j in range(2) for d in (2, 4, 8, 16)])
    seq = [("encoder.initial_block", net.net.encoder.initial_block, images,
            out(enc_i["initial_block"]))]
    x = out(enc_i["initial_block"])
    for name, layer in zip(names, net.net.encoder.layers):
        seq.append((f"encoder.{name}", layer, x, out(enc_i[name])))
        x = out(enc_i[name])
    enc = x
    for name, layer in zip(("up1", "nb64_0", "nb64_1", "up2", "nb16_0",
                            "nb16_1"), net.net.decoder.layers):
        seq.append((f"decoder.{name}", layer, x, out(dec_i[name])))
        x = out(dec_i[name])
    seq.append(("decoder.output_conv", net.net.decoder.output_conv, x,
                out(dec_i["output_conv"])))
    for head in ("line_classification", "horizon_estimation",
                 "homography_head"):
        seq.append((head, getattr(net, head), enc, out(inter[head])))
    return seq


@pytest.fixture(scope="module", params=["eval", "train"])
def layer_case(request):
    mp = pytest.MonkeyPatch()
    mp.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        return request.param, _layer_case(request.param == "train")
    finally:
        mp.undo()


def _layer_case(train):
    kw = dict(resize=RESIZE, learn_homography=True)
    net = kaiming_lanenet(train_sh_config(**kw))
    v = variables_from_state_dict(net.state_dict(), RESIZE)
    images = np.random.default_rng(1).uniform(
        0, 1, (BATCH, RESIZE, 2 * RESIZE, 3)).astype(np.float32)
    jnet = JaxLaneNet(jax_config(**kw), dtype=jnp.bfloat16)
    _, state = jnet.module.apply(v, jnp.asarray(images), train=train,
                                 capture_intermediates=True,
                                 mutable=["intermediates", "batch_stats"])
    net.train(train)
    rows = {}
    for name, layer, x, want in _layers(net, state["intermediates"],
                                        images):
        t = torch.from_numpy(x)
        if t.dim() == 4:
            t = t.permute(0, 3, 1, 2)
        got = {}
        for dt in (BF16, torch.float32):
            # JAX's bf16 activations (the images stay float32, as there)
            xin = t if name == "encoder.initial_block" else t.to(dt)
            with torch.no_grad():
                y = call_in_dtype(layer, dt, xin)
            got[dt] = y
            y = y.float()
            y = (y.permute(0, 2, 3, 1) if y.dim() == 4 else y).numpy()
            diff = np.abs(y - want)
            got[dt, "max"] = diff.max() / np.abs(want).max()
            got[dt, "flips"] = (diff > 0).mean()
        rows[name] = got
    return rows


def test_each_layer_runs_jax_bf16_function(layer_case):
    mode, rows = layer_case
    for name, r in rows.items():
        if name == "homography_head":
            continue  # float32 offsets (tanh in float32), held below
        assert r[BF16].dtype == BF16, name
        assert r[BF16, "max"] <= ULP2, (name, r[BF16, "max"])
        assert r[BF16, "flips"] <= FLIPS[mode], (name, r[BF16, "flips"])


def test_each_layer_control_in_float32_fails(layer_case):
    """The port's float32 layer on the same bf16 input: another function,
    seen on most elements of every layer."""
    _, rows = layer_case
    for name, r in rows.items():
        if name == "homography_head":
            continue
        assert r[torch.float32, "flips"] > CONTROL_FLIPS, (
            name, r[torch.float32, "flips"])


def test_homography_offsets_in_float32(layer_case):
    """tanh / 16 taken in float32 on both sides, from the bf16 head."""
    _, rows = layer_case
    r = rows["homography_head"]
    assert r[BF16].dtype == torch.float32
    assert r[BF16, "max"] <= 1e-3, r[BF16, "max"]


# ----------------------------------------------------------------------
# 2. whole steps
# ----------------------------------------------------------------------

def _jax_step(jcfg, v, jbatch, phase, dtype):
    jnet = JaxLaneNet(jcfg, dtype=dtype)
    loss_fn = jsteps.make_loss_fn(jnet, jcfg, phase, train=True,
                                  use_packed=False)
    loss, (_, out, _) = jax.jit(loss_fn)(v["params"], v["batch_stats"],
                                         jbatch, None)
    beta = np.asarray(out["beta"]) if "beta" in out else None
    return float(loss), beta


def _port_step(cfg, sd, tbatch, phase, dtype_name):
    """One train step of the port in `dtype_name`: loss and beta of the
    forward, the dtypes of the gradients and of adam's state after the
    update."""
    cfg = cfg.replace(compute_dtype=dtype_name)
    net = LaneNet(cfg, device="cpu")
    net.load_state_dict(sd)
    seen = []
    hook = net.net.encoder.layers[1].conv3x1_1.register_forward_hook(
        lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
    loss, _, out = tsteps.make_loss_fn(net, cfg, phase, train=True)(
        {k: torch.from_numpy(a) for k, a in tbatch.items()})
    hook.remove()
    loss.backward()
    opt = define_optim(net.parameters(), "adam", 1e-3)
    opt.step()
    beta = out["beta"].detach().numpy() if "beta" in out else None
    return {"loss": float(loss.detach()), "beta": beta, "hook": seen,
            "loss_dtype": loss.dtype,
            "grads": {p.grad.dtype for p in net.parameters()
                      if p.grad is not None},
            "params": {p.dtype for p in net.parameters()},
            "adam": {t.dtype for s in opt.state.values()
                     for t in s.values() if t.dim() > 0}}


@pytest.fixture(scope="module", params=list(STEPS))
def step_case(request):
    mp = pytest.MonkeyPatch()
    mp.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        return request.param, _step_case(request.param)
    finally:
        mp.undo()


def _step_case(name):
    extra, phase = STEPS[name]
    kw = dict(resize=RESIZE, batch_size=BATCH, reg_ls=1.0, **extra)
    cfg, jcfg = train_sh_config(**kw), jax_config(**kw)
    net = kaiming_lanenet(cfg, damp=0.1)
    sd = {k: t.clone() for k, t in net.state_dict().items()}
    v = variables_from_state_dict(sd, RESIZE)
    batch = _batch(np.random.default_rng(3), cfg)
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    return {"phase": phase,
            "jax": {dt: _jax_step(jcfg, v, jbatch, phase, jdt) for dt, jdt
                    in (("float32", jnp.float32),
                        ("bfloat16", jnp.bfloat16))},
            "port": {dt: _port_step(cfg, sd, batch, phase, dt)
                     for dt in ("float32", "bfloat16")}}


def test_step_runs_bf16_with_float32_parameters(step_case):
    _, r = step_case
    port = r["port"]["bfloat16"]
    assert port["hook"] == [(BF16, BF16)]
    assert port["grads"] == port["params"] == port["adam"] == {
        torch.float32}
    assert port["loss_dtype"] == torch.float32
    assert r["port"]["float32"]["hook"] == [(torch.float32,) * 2]


def test_step_beta_matches_jax_bf16(step_case):
    _, r = step_case
    if r["phase"] == "skip":
        assert r["port"]["bfloat16"]["beta"] is None
        return
    want = r["jax"]["bfloat16"][1]
    got = r["port"]["bfloat16"]["beta"]
    assert got.shape == want.shape
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= BETA_BAR, rel


def test_step_loss_matches_jax_bf16(step_case):
    _, r = step_case
    (jf32, _), (jbf, _) = r["jax"]["float32"], r["jax"]["bfloat16"]
    got = r["port"]["bfloat16"]["loss"]
    assert abs(got - jbf) <= abs(jf32 - jbf) + 2e-3 * abs(jbf), (
        got, jbf, jf32)


def test_step_control_sees_the_dtype(step_case):
    """Distances from JAX's float32 step: the port's bf16 step at least a
    quarter of JAX's bf16 distance, the port's float32 step under it."""
    _, r = step_case
    keys = [("loss", 0)] if r["phase"] == "e2e" else []
    if r["phase"] != "skip":
        keys.append(("beta", 1))
    jf32, jbf = r["jax"]["float32"], r["jax"]["bfloat16"]
    for key, i in keys:
        dist = lambda a: float(np.abs(np.asarray(a) - jf32[i]).max())
        gap = dist(jbf[i])
        assert gap > 0, key
        assert dist(r["port"]["bfloat16"][key]) >= QUARTER * gap, key
        assert dist(r["port"]["float32"][key]) < QUARTER * gap, key


def test_test_model_forward_takes_the_compute_dtype(monkeypatch):
    """Without the engine, `make_infer_fn` runs `LaneNet.forward` in the
    config's compute dtype, as JAX's infer runs its LaneNet's."""
    cfg = train_sh_config(resize=RESIZE, compute_dtype="bfloat16")
    net = LaneNet(cfg, device="cpu")
    seen = []
    forward = net.forward
    monkeypatch.setattr(net, "forward", lambda *a, **k: (
        seen.append(k.get("dtype")), forward(*a, **k))[1])
    infer = test_driver.make_infer_fn(
        net, cfg, Projections(cfg.resize, cfg.order, cfg.no_mapping,
                              device="cpu"))
    lanes = infer(torch.zeros(1, RESIZE, 2 * RESIZE, 3, dtype=torch.uint8))
    assert seen == [BF16]
    assert lanes.dtype == torch.float32 and lanes.shape == (1, 4, 56)
