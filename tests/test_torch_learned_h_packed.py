"""The learned homography on the packed training path: one e2e step of
`LaneNet.apply_packed` (the kernels' plain versions on the CPU), in both
dtypes and every `fused_blocks` x `fused_maps` combination, against
`LaneNet.forward`, and in float32 against the benchmark's plain
reference (`portbench/reference/homography.py`).

Config `train_sh_config(resize=32, reg_ls=1.0, learn_homography=True)`,
batch 2, dropout off, weights drawn by the benchmark's own
`portbench.inputs.make_state` (seed 11, the head's `fc_offsets` among
them, so M moves off the fixed matrix) with every NB1D block's bn2 scale
times 0.1, as tests/test_torch_phases.py damps them: as drawn, a
train-mode step at this size amplifies each change of summation order
(the reference against the packed step: a bias's gradient 15% apart,
whole-gradient cosine 1 - 2.3e-4; damped 3.1e-4 and 1 - 4.9e-9).

Bars, float32 (each beside its reading over the cases): beta, M and
M_inv at 2e-3 of max|.| (tests/test_fused_blocks.py's rtol for a fused
forward; read up to 1.8e-5); the loss at rtol 2e-3 and the heads' losses
at 1e-4 (tests/test_torch_train_step.py; read up to 7.6e-5 and 1.7e-7);
the whole gradient by cosine > 0.999 and norm ratio within 2% of 1
(tests/test_fused_blocks.py; read 1 - 4.9e-9 and 6.8e-5); every leaf
whose gradient is clear of rounding at 2e-3 of its own max|g| (read up
to 3.1e-4), and the leaves whose true gradient is 0 (a bias ahead of a
train-mode BatchNorm) under 1e-4 of the whole gradient's max (read
4.9e-6). In bf16, where the two graphs round in other places: the
packed backbone's bf16 encoder features lie 5.0e-2 of max from the
float32 forward's, the plain graph's 1.9e-2, as the JAX package's own
packed bf16 path lies 5.1e-2 and its flax bf16 graph 1.8e-2 on these
weights. The packed path takes the images into the first convolution in
bf16, as the JAX package's `erfnet_packed` does, where the plain graph
keeps them float32 (rounding the images alone moves the float32
features 3.3e-2), and it rounds each convolution's output before its
BatchNorm takes the moments. The head's offsets follow the features
(5.9e-2 and 1.2e-2). So: beta and M at 3e-2 of max (ROADMAP Queue 3's
bf16 parity limit; read up to 2.2e-3 and 4.8e-3), M_inv at 1e-1, whose
largest entries, the translations, amplify the offsets' error through
the DLT (read up to 5.1e-2; the bf16 forward against the float32 one
1.8e-2), the losses at rtol 6e-2 (tests/test_torch_train_step.py's bf16
bar; read up to 2.4e-2), the whole gradient by cosine > 0.9 (read down
to 0.958; the bf16 forward against the float32 one 0.980) and the head's
by cosine > 0.8 (read down to 0.904, the bf16 forward against the
float32 one 0.952; the control, M detached where the fit takes it,
reads 0.66 and must fall under the bar). The step on the packed path is
the default one (`resolve_packed`), and the forward's `model.homography`
span opens on both graphs.

The default bf16 step is also held against the JAX package's, which
trains this option on its flax graph, on tests/test_torch_bf16_graph.py's
weights and batch for its "e2e-learned" case, at
tests/test_torch_train_step.py's bf16 bars for the packed step against
JAX: the loss at rtol 6e-2 and beta at 3e-2 of max|beta| (read 4.6e-2
and 2.5e-3; the loss takes the packed path's rounding above, which the
flax graph does not share: JAX's own bf16 loss lies 1.7% from its
float32 one there).
"""

import flax.linen as flax_nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import profile

from lanedetection_end2end_tpu.config import train_sh_config as jax_config

from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.models.port import (
    variables_from_state_dict)
from lanedetection_end2end_tpu_torch.ops.wls import WLSFitter
from lanedetection_end2end_tpu_torch.train import steps as tsteps
from lanedetection_end2end_tpu_torch.utils import profiling
from portbench import inputs
from portbench.reference import homography as refhom
from test_torch_bf16_graph import _jax_step, kaiming_lanenet
from test_torch_phases import _batch
from test_torch_threads import one_torch_thread  # noqa: F401

RESIZE, BATCH, SEED = 32, 2, 11
MODEL = dict(profile="bp", resize=RESIZE, out_channels=4, order=3,
             clas=True, activation="square", mask_percentage=0.2,
             reg_ls=1.0, no_mapping=False, loss_policy="backproject",
             weight_fit=1.0, weight_class=1.0)
F32 = {"out": 2e-3, "loss": 2e-3, "heads": 1e-4, "cos": 0.999,
       "ratio": 0.02, "leaf": 2e-3, "still": 1e-4}
BF16 = {"out": 3e-2, "M_inv": 1e-1, "loss": 6e-2, "cos": 0.9,
        "head_cos": 0.8}
TERMS = ("loss", "loss_line", "loss_horizon")


def state():
    s = inputs.make_state(refhom.state_spec(MODEL), SEED, "cpu")
    return {k: v * 0.1 if k.endswith("bn2.weight") else v
            for k, v in s.items()}


def batch():
    return inputs.training_batches(1, BATCH, RESIZE, "bp", SEED, "cpu")[0]


def port_step(dtype, packed, fused_blocks=True, fused_maps=None,
              weights=None, data=None):
    """One e2e loss and backward of the port on `weights` and `data`
    (this module's `state()` and `batch()` if None) -> {losses, beta, M,
    M_inv, grads, packed (resolve_packed's choice), graph (the method
    that ran)}."""
    cfg = train_sh_config(resize=RESIZE, batch_size=BATCH, reg_ls=1.0,
                          learn_homography=True, compute_dtype=dtype,
                          packed_train=packed)
    net = LaneNet(cfg, device="cpu")
    net.load_state_dict(state() if weights is None else weights)
    kept = {}

    def keeping(graph, fn):
        def call(*a, **k):
            kept[graph] = fn(*a, **k)
            return kept[graph]
        return call
    net.forward = keeping("forward", net.forward)
    net.apply_packed = keeping("apply_packed", net.apply_packed)
    loss, metrics, out = tsteps.make_loss_fn(
        net, cfg, "e2e", fused_blocks=fused_blocks,
        fused_maps=fused_maps)(batch() if data is None else data)
    loss.backward()
    (graph, o), = kept.items()
    return {"losses": {k: float(metrics[k]) for k in TERMS},
            "beta": out["beta"].detach(), "M": o.M.detach(),
            "M_inv": o.M_inv.detach(),
            "grads": {k: p.grad.detach().clone()
                      for k, p in net.named_parameters()
                      if p.grad is not None},
            "packed": tsteps.resolve_packed(net, cfg, "e2e"),
            "graph": graph}


def reference_step():
    """The same loss and backward on the plain reference, float32."""
    ref = refhom.LearnedModel(MODEL, "cpu")
    p = {k: v.clone() for k, v in state().items()}
    params = {k: v.requires_grad_() for k, v in p.items()
              if v.is_floating_point() and not k.endswith(
                  ("running_mean", "running_var"))}
    b = batch()
    out = ref.forward(p, b["image"], True)
    terms = ref.losses(out, b)
    terms["loss"].backward()
    return {"losses": {k: float(terms[k].detach()) for k in TERMS},
            "beta": out["beta"].detach(), "M": out["M"].detach(),
            "M_inv": out["M_inv"].detach(),
            "grads": {k: v.grad for k, v in params.items()
                      if v.grad is not None}}


# (dtype, fused_blocks, fused_maps) of the packed step
CASES = {f"{d} {b} blocks, {m} maps": (dtype, fb, fm)
         for d, dtype in (("float32", "float32"), ("bf16", "bfloat16"))
         for b, fb in (("fused", True), ("unfused", False))
         for m, fm in (("fused", True), ("unfused", False))}
CASES["reference"] = ("float32", True, True)
_RUNS = {}


def get(name):
    """(packed step, what it is held against) of case `name`: the plain
    graph's step in the same dtype, or the reference's."""
    if name not in _RUNS:
        dtype, blocks, maps = CASES[name]
        if name == "reference":
            want = reference_step()
        else:
            want = _RUNS.setdefault(dtype, port_step(dtype, False))
        _RUNS[name] = (port_step(dtype, None, blocks, maps), want)
    return _RUNS[name]


def rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def whole(grads, keys):
    return torch.cat([grads[k].flatten() for k in keys])


@pytest.mark.parametrize("name", list(CASES))
def test_packed_step_is_the_default_path(name):
    got, want = get(name)
    assert got["packed"] and got["graph"] == "apply_packed"
    if name != "reference":
        assert not want["packed"] and want["graph"] == "forward"


@pytest.mark.parametrize("name", list(CASES))
def test_beta_and_matrices(name):
    got, want = get(name)
    bars = BF16 if CASES[name][0] == "bfloat16" else F32
    for k in ("beta", "M", "M_inv"):
        assert got[k].shape == want[k].shape, k
        bar = bars.get(k, bars["out"])
        assert rel(got[k], want[k]) <= bar, (k, rel(got[k], want[k]))
    assert got["M"].dtype == got["M_inv"].dtype == torch.float32


@pytest.mark.parametrize("name", list(CASES))
def test_loss_terms(name):
    got, want = get(name)
    for k in TERMS:
        if CASES[name][0] == "bfloat16":
            bar = BF16["loss"]
        else:
            bar = F32["loss"] if k == "loss" else F32["heads"]
        gap = abs(got["losses"][k] - want["losses"][k]) / abs(
            want["losses"][k])
        assert gap <= bar, (k, gap)


@pytest.mark.parametrize("name", list(CASES))
def test_whole_and_head_gradients(name):
    got, want = get(name)
    g, w = got["grads"], want["grads"]
    assert set(g) == set(w)
    keys = sorted(w)
    head = [k for k in keys if k.startswith("homography_head.")]
    assert len(head) == 20
    a, b = whole(g, keys), whole(w, keys)
    if CASES[name][0] == "bfloat16":
        assert cosine(a, b) > BF16["cos"], cosine(a, b)
        assert cosine(whole(g, head), whole(w, head)) > BF16["head_cos"]
        return
    assert cosine(a, b) > F32["cos"], cosine(a, b)
    assert abs(float(a.norm() / b.norm()) - 1.0) < F32["ratio"]


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n][0] == "float32"])
def test_every_leaf_gradient(name):
    """Leaf by leaf, the homography head's included: where the gradient
    is clear of rounding, at 2e-3 of its own max; where its true value
    is 0, small against the whole gradient's max."""
    got, want = get(name)
    top = max(float(v.abs().max()) for v in want["grads"].values())
    clear = 0
    for k, w in want["grads"].items():
        g = got["grads"][k]
        if float(w.abs().max()) > F32["still"] * top:
            assert rel(g, w) <= F32["leaf"], (k, rel(g, w))
            clear += k.startswith("homography_head.")
        else:
            assert float(g.abs().max()) <= F32["still"] * top, k
    assert clear >= 8


def test_homography_span_on_both_graphs():
    """The head, the DLT and the coefficient rows run under the
    `model.homography` span inside `model.forward`, once a step, on the
    packed path and on the plain graph."""
    for packed in (None, False):
        profiling.reset_spans()
        with profile():
            port_step("float32", packed)
        summary = profiling.span_summary()
        assert summary["model.homography"]["count"] == 1, packed
        recs = profiling.span_records()
        by_index = {r.index: r for r in recs}
        hom = [r for r in recs if r.name == "model.homography"]
        assert by_index[hom[0].parent].name == "model.forward"
    profiling.reset_spans()


def test_bf16_head_bar_sees_M_detached_at_the_fit(monkeypatch):
    """The control for the head's bf16 bar: the default bf16 step with M
    detached where the fit takes it, against the plain bf16 step."""
    _, want = get("bf16 fused blocks, fused maps")
    sep = WLSFitter.sep_coeff_from_M
    monkeypatch.setattr(WLSFitter, "sep_coeff_from_M",
                        lambda self, M: sep(self, M.detach()))
    got = port_step("bfloat16", None)
    head = sorted(k for k in want["grads"]
                  if k.startswith("homography_head."))
    gap = cosine(whole(got["grads"], head), whole(want["grads"], head))
    assert gap < BF16["head_cos"], gap


@pytest.fixture(scope="module")
def jax_bf16():
    """The default bf16 step and the JAX package's flax bf16 step on
    tests/test_torch_bf16_graph.py's "e2e-learned" weights and batch."""
    mp = pytest.MonkeyPatch()
    mp.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        kw = dict(resize=RESIZE, batch_size=BATCH, reg_ls=1.0,
                  learn_homography=True)
        cfg = train_sh_config(**kw)
        sd = {k: t.clone()
              for k, t in kaiming_lanenet(cfg, damp=0.1).state_dict().items()}
        data = _batch(np.random.default_rng(3), cfg)
        want = _jax_step(jax_config(**kw), variables_from_state_dict(sd, RESIZE),
                         {k: jnp.asarray(a) for k, a in data.items()}, "e2e",
                         jnp.bfloat16)
        got = port_step("bfloat16", None, weights=sd,
                        data={k: torch.from_numpy(a) for k, a in data.items()})
        return got, want
    finally:
        mp.undo()


def test_default_bf16_step_matches_jax(jax_bf16):
    (got, (loss, beta)) = jax_bf16
    assert got["packed"] and got["graph"] == "apply_packed"
    assert abs(got["losses"]["loss"] - loss) <= BF16["loss"] * abs(loss), (
        got["losses"]["loss"], loss)
    b = got["beta"].float().numpy()
    assert b.shape == beta.shape
    gap = np.abs(b - beta).max() / np.abs(beta).max()
    assert gap <= BF16["out"], gap
