"""Faults planted in the program's timed path, and the controls put in its
place, for the checks that `correct` has to fail: the tests under
`portbench/tests` at a small size, `portbench/calibrate.py` on the card
at a cell's size. The benchmark's own runs plant nothing.

Each is a context manager that patches an entry point of the program for
the block:

- `unchanged`: the train step returns its state unchanged (parameters
  and BatchNorm statistics put back after it);
- `half`: half of the batch left out (train: the step sees the first half
  and takes its means over it; serve: the engine computes the first half
  and repeats it);
- `altered`: an answer altered where it is produced (train: the step's
  loss 1% high; serve: every point of the first image's lanes 25 px to
  the right, beyond TuSimple's 20 px tolerance of a point, a gated one
  served at 23 px);
- `control`: the control of a serving cell, the reference put in the
  infer function's place one precision below each stage the
  configuration states (`_serve_control`).

The training cells' control is the program's own bf16 path, the
configuration's `compute_dtype` set to bfloat16 (`calibrate.py --mode
control`).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _wrap_step(change):
    """make_train_step patched so that each step is `change(step, batch,
    generator, module)`."""
    from lanedetection_end2end_tpu_torch.train import steps

    def make(orig):
        def make_train_step(lanenet, *a, **k):
            step = orig(lanenet, *a, **k)

            def broken(batch, generator=None):
                return change(step, batch, generator, lanenet)
            broken.state = step.state
            return broken
        return make_train_step
    return _patched(steps, "make_train_step", make)


def _train_unchanged(step, batch, generator, net):
    before = {k: v.detach().clone() for k, v in net.state_dict().items()}
    metrics = step(batch, generator)
    net.load_state_dict(before)
    return metrics


def _train_half(step, batch, generator, net):
    n = batch["image"].shape[0] // 2
    return step({k: v[:n] for k, v in batch.items()}, generator)


def _train_altered(step, batch, generator, net):
    metrics = dict(step(batch, generator))
    metrics["loss"] = metrics["loss"] * 1.01
    return metrics


def _engine_call(change):
    from lanedetection_end2end_tpu_torch.models import infer_engine as ie

    def make(orig):
        def __call__(self, packed, images):
            return change(orig, self, packed, images)
        return __call__
    return _patched(ie.FusedLaneNetEngine, "__call__", make)


def _serve_half(orig, engine, packed, images):
    n = images.shape[0] // 2
    out = orig(engine, packed, images[:n])
    return tuple(None if t is None else torch.cat([t, t], 0) for t in out)


@contextlib.contextmanager
def _serve_altered():
    from lanedetection_end2end_tpu_torch.eval import test_driver as td

    def make(orig):
        def make_infer_fn(*a, **k):
            infer = orig(*a, **k)

            def broken(images):
                lanes = infer(images).clone()
                lanes[0] += 25.0
                return lanes
            return broken
        return make_infer_fn
    with _patched(td, "make_infer_fn", make):
        yield


@contextlib.contextmanager
def _serve_control():
    """The infer function replaced by the reference one precision below
    each stage the configuration states: every convolution's and linear
    layer's input and weight in float8 e4m3 (the bf16 engine), the fit's
    moments and the projection on bfloat16 operands (float32 there); the
    gates on its own logits. It runs on the weights the program was
    given and records its beta and logits where the program's would be."""
    from lanedetection_end2end_tpu_torch.eval import test_driver as td
    from portbench.reference import check, model

    def make(orig):
        def make_infer_fn(lanenet, cfg, projections, engine=None,
                          packed=None):
            ref = model.Model(_model_of(cfg), engine.device,
                              round_tail=check.bf16)
            state = {k: v.detach().clone()
                     for k, v in lanenet.state_dict().items()}

            def infer(images):
                x = images.to(engine.device).float() * (1.0 / 255.0)
                with check.exact_float32(), torch.no_grad(), \
                        check.rounded(check.fp8_e4m3):
                    out = ref.forward(state, x, train=False)
                    lanes, _ = ref.lanes(out["beta"], out.get("line"),
                                         out.get("horizon"))
                if getattr(engine, "outputs", None) is not None:
                    engine.outputs.append((out["beta"], out.get("line"),
                                           out.get("horizon")))
                return lanes
            return infer
        return make_infer_fn
    with _patched(td, "make_infer_fn", make):
        yield


def _model_of(cfg) -> dict:
    """The reference's `model` section from the program's config."""
    return {"profile": cfg.profile, "resize": cfg.resize,
            "out_channels": cfg.out_channels, "order": cfg.order,
            "clas": cfg.clas, "activation": cfg.activation_layer,
            "mask_percentage": cfg.mask_percentage, "reg_ls": cfg.reg_ls,
            "no_mapping": cfg.no_mapping, "loss_policy": cfg.loss_policy,
            "weight_fit": cfg.weight_fit, "weight_class": cfg.weight_class}


TRAIN = {"unchanged": lambda: _wrap_step(_train_unchanged),
         "half": lambda: _wrap_step(_train_half),
         "altered": lambda: _wrap_step(_train_altered)}
SERVE = {"half": lambda: _engine_call(_serve_half),
         "altered": _serve_altered,
         "control": _serve_control}
