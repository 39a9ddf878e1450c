"""Profiling harness: does the float32 default e2e step reproduce itself,
and what do cuDNN's deterministic algorithms cost it?

The step of `tools/prof_train.py` (train.sh config, seeded weights, one
synthetic batch, dropout from a seeded generator) is built twice: once as
`train/steps.py` builds it, with cuDNN's deterministic algorithms for the
heads (`deterministic_cudnn`), once with cuDNN's default choice. For each:
one step moves the state off its start, then `pairs` more steps are taken
from that one state (weights, optimizer state, batch, generator) and the
gradients that differ from the first's are counted; then the card's busy
ms a step over `traced` traced steps (`utils/profiling.py`), the two
builds in turns (default, deterministic, deterministic, default) on one
card. TF32 is off for cuDNN, as `chip_smoke.py` runs the step, unless
`--tf32 true` (PyTorch's default for cuDNN).

    python -m lanedetection_end2end_tpu_torch.tools.prof_step_repro \\
        [--bs 8] [--pairs 3] [--traced 4] [--tf32 false]

Prints the card's name and power limit first and one JSON object last.
Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import tempfile
from typing import Dict

import torch

from lanedetection_end2end_tpu_torch.config import str2bool
from lanedetection_end2end_tpu_torch.tools.prof_train import setup
from lanedetection_end2end_tpu_torch.train import steps
from lanedetection_end2end_tpu_torch.utils.profiling import (
    card_line, summarize, synchronize, trace)


def build(bs: int, device, deterministic: bool):
    """(step, batch, generator) with cuDNN's deterministic algorithms for
    the heads, as the step is built, or with its default ones."""
    chosen = steps.deterministic_cudnn
    if not deterministic:
        steps.deterministic_cudnn = contextlib.nullcontext
    try:
        return setup(bs, device)
    finally:
        steps.deterministic_cudnn = chosen


def reruns(step, batch, gen, pairs: int) -> Dict:
    """Gradients of `pairs` steps from one state that differ from the
    first's, and whether the losses agree."""
    step(batch, gen)
    model, opt = step.state.model, step.state.optimizer
    state = copy.deepcopy(model.state_dict())
    opt_state = copy.deepcopy(opt.state_dict())
    gen_state = gen.get_state()

    def one():
        model.load_state_dict(state)
        opt.load_state_dict(copy.deepcopy(opt_state))  # updated in place
        gen.set_state(gen_state)
        loss = step(batch, gen)["loss"].item()
        return loss, {k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None}

    loss0, g0 = one()
    differ, losses = [], []
    for _ in range(pairs):
        loss, g = one()
        losses.append(loss == loss0)
        differ.append(sum(not torch.equal(g0[k], g[k]) for k in g0))
    return {"gradients": len(g0), "differ": differ, "losses_equal": losses}


def busy_ms(step, batch, gen, traced: int) -> float:
    """The card's busy ms a step over `traced` traced steps."""
    for _ in range(2):
        step(batch, gen)
    synchronize(batch["image"].device)
    with trace(tempfile.mkdtemp(prefix="prof_step_repro_")) as t:
        for _ in range(traced):
            step(batch, gen)
        synchronize(batch["image"].device)
    return summarize(t.dir, iters=traced).us_per_iter() / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--traced", type=int, default=4)
    ap.add_argument("--tf32", type=str2bool, default=False)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prof_step_repro needs a card")
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = a.tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    built = {name: build(a.bs, device, name == "deterministic")
             for name in ("default", "deterministic")}
    out = {"tf32": a.tf32, "bs": a.bs}
    for name, (step, batch, gen) in built.items():
        out[name] = reruns(step, batch, gen, a.pairs)
        print(f"{name} cuDNN algorithms: {out[name]['differ']} of "
              f"{out[name]['gradients']} gradients differ from the first "
              f"step's in {a.pairs} reruns from one state; losses equal "
              f"{out[name]['losses_equal']}")
    for name in ("default", "deterministic", "deterministic", "default"):
        ms = busy_ms(*built[name], a.traced)
        out.setdefault(name, {}).setdefault("busy_ms", []).append(ms)
        print(f"{name} cuDNN algorithms: card busy {ms:.3f} ms a step "
              f"(TF32 {'on' if a.tf32 else 'off'} for cuDNN)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
