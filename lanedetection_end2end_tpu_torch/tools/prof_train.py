"""Profiling harness: trace the e2e train step on the card.

Counterpart of `tools/prof_train.py`: one e2e train step of
`train/steps.py::make_train_step` (forward, backward, adam, BatchNorm
statistics) on `train_sh_config(resize=256, reg_ls=1.0)`, seeded weights,
one device-resident batch of `data/synthetic.py::SyntheticLanes`, dropout
drawn from a seeded generator: `warm` steps, `timed` steps (images/s and
ms a step, host clock, synchronized), then `traced` steps under the trace
tool (`utils/profiling.py`), summarized per category and per op. The
JAX tool's environment switches are flags here: `BS` is `--bs`,
`BENCH_PACKED` is `--packed_train`, `PACKED_FUSED_BLOCKS` and
`PACKED_FUSED_MAPS` are `--fused_blocks` and `--fused_maps`. The default
is the config's float32 step on the default kernel path (K6-K10).

    python -m lanedetection_end2end_tpu_torch.tools.prof_train \\
        [--bs 32] [--warm 3] [--timed 20] [--traced 10] [--top 40] \\
        [--compute_dtype float32|bfloat16] [--fused_blocks true|false] \\
        [--fused_maps true|false] [--packed_train true|false] \\
        [--trace_dir DIR] [--device cuda]

It prints the card's name and power limit first. It runs on the card and
raises without one; `--device cpu` runs the plain versions on the host.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import Dict, Optional

import torch

from lanedetection_end2end_tpu_torch.config import (
    str2bool, train_sh_config)
from lanedetection_end2end_tpu_torch.data.synthetic import SyntheticLanes
from lanedetection_end2end_tpu_torch.device import resolve_device
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.ops.nb_block import nb_half_a, nb_half_b
from lanedetection_end2end_tpu_torch.train.optim import define_optim
from lanedetection_end2end_tpu_torch.train.steps import make_train_step
from lanedetection_end2end_tpu_torch.utils.profiling import (
    card_line, summarize, synchronize, trace)


def _half_calls() -> Dict[str, int]:
    """The K6/K7 wrappers' launch counters."""
    return {"nb_half_a": nb_half_a.launches,
            "nb_half_a_bwd": nb_half_a.bwd_launches,
            "nb_half_b": nb_half_b.launches,
            "nb_half_b_bwd": nb_half_b.bwd_launches}


def setup(bs: int, device, resize: int = 256, seed: int = 0,
          compute_dtype: str = "float32", fused_blocks: bool = True,
          fused_maps: Optional[bool] = None,
          packed_train: Optional[bool] = None):
    """-> (step, batch on `device`, generator): the train step on weights
    drawn from `seed`."""
    cfg = train_sh_config(resize=resize, batch_size=bs, reg_ls=1.0,
                          compute_dtype=compute_dtype,
                          packed_train=packed_train)
    torch.manual_seed(seed)
    lanenet = LaneNet(cfg, device=device)
    opt = define_optim(lanenet.parameters(), cfg.optimizer,
                       cfg.learning_rate)
    step = make_train_step(lanenet, cfg, opt, "e2e", device=device,
                           fused_blocks=fused_blocks, fused_maps=fused_maps)
    batch = {k: torch.from_numpy(v).to(device) for k, v in SyntheticLanes(
        bs, resize, cfg.nclasses, "bp", seed=seed).batch().items()}
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return step, batch, gen


def run(bs: int = 32, warm: int = 3, timed: int = 20, traced: int = 10,
        trace_dir=None, device=None, resize: int = 256, **options) -> Dict:
    """-> {"img_per_s", "ms_per_step", "summary" (a TraceSummary of the
    traced steps), "trace" (its TraceHandle), "half_calls" (the K6/K7
    wrappers' calls during the traced steps), "loss" (the last step's)}.
    `options`: `setup`'s keywords."""
    device = resolve_device(device)
    step, batch, gen = setup(bs, device, resize, **options)
    for _ in range(warm):
        step(batch, gen)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(timed):
        metrics = step(batch, gen)
    synchronize(device)
    secs = time.perf_counter() - t0
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="prof_train_")
    before = _half_calls()
    with trace(trace_dir) as t:
        for _ in range(traced):
            metrics = step(batch, gen)
        synchronize(device)
    after = _half_calls()
    return {"img_per_s": bs * timed / secs, "ms_per_step": 1e3 * secs / timed,
            "summary": summarize(t.dir, iters=traced), "trace": t,
            "half_calls": {k: after[k] - before[k] for k in after},
            "loss": float(metrics["loss"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--timed", type=int, default=20)
    ap.add_argument("--traced", type=int, default=10)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--compute_dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--fused_blocks", type=str2bool, default=True)
    ap.add_argument("--fused_maps", type=str2bool, default=None)
    ap.add_argument("--packed_train", type=str2bool, default=None)
    ap.add_argument("--trace_dir", default=None)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    res = run(a.bs, a.warm, a.timed, a.traced, a.trace_dir, device,
              compute_dtype=a.compute_dtype, fused_blocks=a.fused_blocks,
              fused_maps=a.fused_maps, packed_train=a.packed_train)
    print(f"throughput {res['img_per_s']:.1f} img/s  "
          f"({res['ms_per_step']:.2f} ms/step)", flush=True)
    print(res["summary"].format(top=a.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
