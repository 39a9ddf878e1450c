"""Host-to-card feed probe: what one batch of the loader's images costs to
bring onto the card, alone and beside compute.

Counterpart of `tools/prof_feed.py`. One uint8 batch of the loader's image
payload, (BS, 256, 512, 3), is measured six ways, N batches each (host
clock around the whole loop, the card synchronized at its end):

  put_sync       : a copy from pinned memory, then synchronize, a batch
                   at a time (the raw feed rate)
  put_pipelined  : the copy of batch n+1 issued on a side stream before
                   waiting on batch n's (do copies queue back to back?)
  put_overlap    : the copies on a side stream while a chain of float32
                   matmuls on resident data runs on the compute stream
                   (does a copy overlap compute?); the chain alone is
                   printed after it
  step_resident  : a compute proxy on a resident batch (the widening of
                   the uint8 images, their mean, and the matmul chain)
  step_fresh     : a pinned copy, then the proxy on it, in sequence (the
                   naive loop)
  step_lookahead : the proxy on batches from `data/loader.py::
                   DevicePrefetcher` (its thread pins and copies batch
                   n+1 on its side stream while the proxy runs on n), the
                   Trainer's feed

    python -m lanedetection_end2end_tpu_torch.tools.prof_feed \\
        [--bs 32] [--n 20] [--size 2048] [--chain 30] [--device cuda]

It prints the card's name and power limit first, then one line each:
MB/s, img/s and ms a batch. It runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict

import numpy as np
import torch

from lanedetection_end2end_tpu_torch.data.loader import DevicePrefetcher
from lanedetection_end2end_tpu_torch.device import resolve_device
from lanedetection_end2end_tpu_torch.utils.profiling import (
    card_line, synchronize)

MODES = ("put_sync", "put_pipelined", "put_overlap", "step_resident",
         "step_fresh", "step_lookahead")


def burn(a: torch.Tensor, chain: int) -> torch.Tensor:
    """`chain` float32 matmuls of the square `a`, each squashed."""
    for _ in range(chain):
        a = torch.tanh(a @ a) * 1e-3
    return a


def consume(x: torch.Tensor, a: torch.Tensor, chain: int) -> torch.Tensor:
    """The train-step proxy: the uint8 batch widened and reduced, then the
    matmul chain (which reads the reduction, so it waits on the batch)."""
    v = x.float().mean()
    for _ in range(chain):
        a = torch.tanh(a @ a) * (1e-3 + v * 0)
    return a


def run(bs: int = 32, n: int = 20, size: int = 2048, chain: int = 30,
        device=None) -> Dict[str, float]:
    """-> {mode: seconds for `n` batches} for each of MODES, plus
    "burn_alone" (one chain) and "batch_mb"."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    batch = np.random.default_rng(0).integers(
        0, 255, (bs, 256, 512, 3)).astype(np.uint8)
    host = torch.from_numpy(batch)
    if cuda:
        host = host.pin_memory()
    side = torch.cuda.Stream(device) if cuda else None
    a = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (size, size)).astype(np.float32)).to(device)
    put = lambda: host.to(device, non_blocking=True)
    secs = {"batch_mb": batch.nbytes / 1e6}

    def timed(name, fn):
        synchronize(device)
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        secs[name] = time.perf_counter() - t0

    def on_side(fn):
        """fn() on the side stream (the compute stream on the CPU) ->
        (its result, an event recorded after it, or None)."""
        if not cuda:
            return fn(), None
        with torch.cuda.stream(side):
            out = fn()
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    def wait(event):
        if event is not None:
            event.synchronize()

    put()  # warm: the pinned pool, the copy engine
    burn(a, chain)
    consume(put(), a, chain)

    def put_sync():
        for _ in range(n):
            put()
            synchronize(device)

    def put_pipelined():
        prev = None
        for _ in range(n):
            cur = on_side(put)[1]
            wait(prev)
            prev = cur
        wait(prev)

    def put_overlap():
        out = burn(a, chain)
        for _ in range(n):
            wait(on_side(put)[1])
        return out

    resident = put()

    def step_resident():
        for _ in range(n):
            consume(resident, a, chain)

    def step_fresh():
        for _ in range(n):
            consume(put(), a, chain)

    def step_lookahead():
        feed = DevicePrefetcher(({"image": batch} for _ in range(n)),
                                device, depth=1)
        for item in feed:
            consume(item["image"], a, chain)

    timed("put_sync", put_sync)
    timed("put_pipelined", put_pipelined)
    timed("put_overlap", put_overlap)
    timed("burn_alone", lambda: burn(a, chain))
    timed("step_resident", step_resident)
    timed("step_fresh", step_fresh)
    timed("step_lookahead", step_lookahead)
    return secs


def report(name: str, secs: float, n: int, bs: int, mb: float) -> str:
    return (f"{name:16s} {n * mb / secs:8.1f} MB/s  {n * bs / secs:8.1f} "
            f"img/s  ({secs / n * 1e3:.2f} ms/batch)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--chain", type=int, default=30)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    secs = run(a.bs, a.n, a.size, a.chain, device)
    for name in MODES:
        print(report(name, secs[name], a.n, a.bs, secs["batch_mb"]),
              flush=True)
        if name == "put_overlap":
            print(f"burn alone: {secs['burn_alone'] * 1e3:.1f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
