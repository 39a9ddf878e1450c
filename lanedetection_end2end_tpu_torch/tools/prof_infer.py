"""Profiling harness: trace the serving path on the card.

Counterpart of `tools/prof_infer.py`: `eval/test_driver.py::make_infer_fn`
with the serving engine (`FusedLaneNetEngine`: the full path's
`encoder_fused` and `decoder_fused`, the fit, the gating of the line and
horizon heads and the projection to TuSimple coordinates) on
`train_sh_config(resize=256, reg_ls=1.0)`, seeded weights, a batch of
uniform images: `warm` calls, `timed` calls (images/s and ms a batch,
host clock, synchronized), then `traced` calls under the trace tool
(`utils/profiling.py`), summarized per category and per op.

    python -m lanedetection_end2end_tpu_torch.tools.prof_infer \\
        [--bs 32] [--warm 5] [--timed 50] [--traced 20] [--top 30] \\
        [--trace_dir DIR] [--device cuda]

It prints the card's name and power limit first. It runs on the card and
raises without one; `--device cpu` runs the plain versions on the host
(no device events, so the summary is empty).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.device import resolve_device
from lanedetection_end2end_tpu_torch.eval.projections import Projections
from lanedetection_end2end_tpu_torch.eval.test_driver import make_infer_fn
from lanedetection_end2end_tpu_torch.models.infer_engine import (
    FusedLaneNetEngine)
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.utils.profiling import (
    card_line, summarize, synchronize, trace)


def setup(bs: int, device, resize: int = 256, seed: int = 0):
    """-> (infer, images (bs, resize, 2 resize, 3) float32 on `device`):
    the engine's infer function on weights drawn from `seed`."""
    cfg = train_sh_config(resize=resize, batch_size=bs, reg_ls=1.0)
    torch.manual_seed(seed)
    lanenet = LaneNet(cfg, device=device)
    engine = FusedLaneNetEngine(cfg, device=device)
    packed = engine.prepare(lanenet.state_dict())
    infer = make_infer_fn(
        lanenet, cfg, Projections(cfg.resize, cfg.order, cfg.no_mapping,
                                  device=device), engine, packed)
    images = torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (bs, cfg.image_height, cfg.image_width, 3)).astype(
            np.float32)).to(device)
    return infer, images


def run(bs: int = 32, warm: int = 5, timed: int = 50, traced: int = 20,
        trace_dir=None, device=None, resize: int = 256) -> Dict:
    """-> {"img_per_s", "ms_per_batch", "summary" (a TraceSummary of the
    traced calls), "trace" (its TraceHandle), "lanes" (the last output)}."""
    device = resolve_device(device)
    infer, images = setup(bs, device, resize)
    for _ in range(warm):
        infer(images)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(timed):
        lanes = infer(images)
    synchronize(device)
    secs = time.perf_counter() - t0
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="prof_infer_")
    with trace(trace_dir) as t:
        for _ in range(traced):
            lanes = infer(images)
        synchronize(device)
    return {"img_per_s": bs * timed / secs,
            "ms_per_batch": 1e3 * secs / timed,
            "summary": summarize(t.dir, iters=traced), "trace": t,
            "lanes": lanes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--timed", type=int, default=50)
    ap.add_argument("--traced", type=int, default=20)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--trace_dir", default=None)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    res = run(a.bs, a.warm, a.timed, a.traced, a.trace_dir, device)
    print(f"throughput {res['img_per_s']:.1f} img/s  "
          f"({res['ms_per_batch']:.2f} ms/batch)", flush=True)
    print(res["summary"].format(top=a.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
