"""Profiling harness: one NB1D block applied REPS times per launch, with S
images per launch against one.

Counterpart of `tools/prof_block_stack.py` (`run_block`, the
`pl.pallas_call` at :67), the decision experiment for row-stacking: one
NB1D-128 block (d = 2, the encoder's hot shape, a 32 x 64 x 128 bf16 plane
per image) REPS times inside one kernel, with S images per grid step
against one. Here the kernel is `nb1d_chain` (`csrc/nb1d_chain.cu`) with
the block listed REPS times, one cooperative launch, and S images per grid
step become S images per launch: B/S launches of S images each. Every
pixel runs the same tile code whatever S is, so the stacked outputs must
equal the S = 1 outputs bit for bit (JAX holds them to 1e-1).

    python -m lanedetection_end2end_tpu_torch.tools.prof_block_stack \\
        [--bs 32] [--reps 8] [--stacks 1,2,4] [--device cuda]

prints `BS=.. REPS=.. STACK=S: <x> block-img/s` per S, as the JAX tool
does: images times REPS per second, the best of 3 rounds of 10 passes over
the batch, timed with CUDA events on the card. On `--device cpu` the
wrapper runs its plain version (`nb1d_chain_plain`) and the rate is the
host's. The constants are drawn as the JAX tool draws them (numpy
`default_rng(0)`, the same distributions and order) and laid out as
`ops/nb1d.py::pack_nb1d` lays out a block. The plane and the block are
fixed, as in the JAX tool; `setup` builds other shapes for the tests.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Sequence

import numpy as np
import torch

from lanedetection_end2end_tpu_torch.ops.nb1d import (
    MAX_CHAIN, nb1d_chain, pack_chain)

# the JAX tool's constants, in the order it draws them: name -> (mean, shape
# as a function of C)
CONSTS = (("Kh1", 0.0, 3), ("Kw1", 0.0, 3), ("Kh2", 0.0, 3), ("Kw2", 0.0, 3),
          ("b1", 0.0, 0), ("m1", 1.0, 0), ("a1", 0.0, 0), ("b3", 0.0, 0),
          ("m2", 1.0, 0), ("a2", 0.0, 0))
H, W, C, D = 32, 64, 128, 2  # the JAX tool's plane per image and dilation


def draw(bs: int, height: int = H, width: int = W, channels: int = C):
    """The JAX tool's draws -> ({name: float64 array}, x (bs, height,
    width, channels) float64): taps (3, C, C) [tap][ci][co] at scale 0.05,
    vectors (1, C), then the input plane N(0, 1)."""
    rng = np.random.default_rng(0)
    consts = {}
    for name, mean, taps in CONSTS:
        shape = (taps, channels, channels) if taps else (1, channels)
        consts[name] = rng.normal(mean, 0.05, shape)
    x = rng.normal(0, 1, (bs, height, width * channels))
    return consts, x.reshape(bs, height, width, channels)


def block(consts: Dict[str, np.ndarray], dilation: int,
          device: torch.device) -> Dict:
    """The drawn constants in `pack_nb1d`'s layout: w (4, 3, C, C) bf16 =
    [Kh1, Kw1, Kh2, Kw2], vec (6, C) f32 = b1 m1 a1 b3 m2 a2."""
    t = lambda a, dt: torch.from_numpy(np.asarray(a)).to(device, dt)
    w = torch.stack([t(consts[k], torch.bfloat16)
                     for k in ("Kh1", "Kw1", "Kh2", "Kw2")])
    vec = torch.cat([t(consts[k], torch.float32)
                     for k in ("b1", "m1", "a1", "b3", "m2", "a2")])
    return {"w": w.contiguous(), "vec": vec.contiguous(),
            "dilation": int(dilation)}


def run_stacked(x: torch.Tensor, chain: Dict, stack: int) -> torch.Tensor:
    """The chain on x (B, H, W, C) as B/stack launches of `stack` images."""
    B = x.shape[0]
    if B % stack:
        raise ValueError(f"batch {B} is not a multiple of the stack {stack}")
    return torch.cat([nb1d_chain(x[i:i + stack], chain)
                      for i in range(0, B, stack)])


ROUNDS, PASSES = 3, 10  # timing: the best of 3 rounds of 10 passes


def block_img_per_s(x: torch.Tensor, chain: Dict, stack: int) -> float:
    """Images times blocks per second of `run_stacked`, the best of ROUNDS
    rounds of PASSES passes (CUDA events on the card, the host clock on the
    CPU)."""
    work = x.shape[0] * len(chain["dilations"]) * PASSES
    run_stacked(x, chain, stack)  # warm-up (and the build)
    best = 0.0
    for _ in range(ROUNDS):
        if x.device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(PASSES):
                run_stacked(x, chain, stack)
            b.record()
            b.synchronize()
            secs = a.elapsed_time(b) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(PASSES):
                run_stacked(x, chain, stack)
            secs = time.perf_counter() - t0
        best = max(best, work / secs)
    return best


def setup(bs: int, reps: int, device, height: int = H, width: int = W,
          channels: int = C, dilation: int = D) -> tuple:
    """-> (x (bs, height, width, channels) bf16, the chain of `reps`
    copies of the drawn block), on `device`."""
    if not 1 <= reps <= MAX_CHAIN:
        raise ValueError(f"reps {reps} not in 1..{MAX_CHAIN}")
    device = torch.device(device)
    consts, x = draw(bs, height, width, channels)
    x = torch.from_numpy(x).to(device, torch.bfloat16).contiguous()
    return x, pack_chain([block(consts, dilation, device)] * reps)


def run(bs: int = 32, reps: int = 8, stacks: Sequence[int] = (1, 2, 4),
        device="cuda", timed: bool = True) -> Dict:
    """The harness at the tool's plane: -> {"x", "chain", "outputs": {S:
    y}, "equal": {S: y == the S = 1 output bit for bit}, "rates": {S:
    block-img/s} (if timed)}."""
    x, chain = setup(bs, reps, device)
    outputs = {s: run_stacked(x, chain, s)
               for s in dict.fromkeys((1, *stacks))}
    res = {"x": x, "chain": chain, "outputs": outputs,
           "equal": {s: torch.equal(outputs[s], outputs[1]) for s in stacks}}
    if timed:
        res["rates"] = {s: block_img_per_s(x, chain, s) for s in stacks}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--stacks", default="1,2,4")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    stacks = [int(s) for s in a.stacks.split(",")]
    res = run(a.bs, a.reps, stacks, a.device)
    on = ("" if res["x"].device.type == "cuda"
          else " (cpu, plain version)")
    for s in stacks:
        parity = "" if res["equal"][s] else ", NOT bit for bit the STACK=1 "
        print(f"BS={a.bs} REPS={a.reps} STACK={s}: {res['rates'][s]:.1f} "
              f"block-img/s{on}{parity}", flush=True)
    return 0 if all(res["equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
