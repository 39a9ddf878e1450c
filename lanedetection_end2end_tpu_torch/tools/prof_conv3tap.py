"""Card time of the 3-tap tiles (K6 / K7, K11) for one checkout of the port:
the bf16 tiles beside cuDNN's, and the float32 convolution tile by C.

`--dtype bfloat16` (the default) runs `chip_smoke.py`'s own per-shape
loops in bf16 (those of `--tiles-only`): the half blocks `nb_half_a` /
`nb_half_b` forward and backward at each (plane, d) of the default
256x512 train step at batch 8 beside cuDNN's products alone, and K11
(`packed_conv_act`, `packed_conv`) at each (plane, d, axis) of the
unfused step beside cuDNN's call, each held against its plain version
and timed in card time (`card_ms`).

`--dtype float32` times the float32 convolution tile
(`conv3tap_f32_kernel` in `csrc/conv3tap_f32.cuh`, with the launch's
weight split where the checkout has one) at the same (plane, d) of the
default step, at batch 8 and at each `--batch`: the half blocks forward
(two convolutions, row then column taps) and backward (their two input
gradients) under `torch.profiler`, the kernel's device time summed by C
and weighted by the step's launches (17 + 17 half blocks, 68 forward and
68 input-gradient launches). At each batch each half block's output and
input gradient are first held at 1e-4 of max|plain| against the plain
version on `ops/tf32x3.py::conv3_tf32x3`, the tile's own arithmetic.

What this tool adds is `--root`: the wrappers timed are those of the
port in DIR (default: this checkout), whose wrappers take the same
arguments, so that one call on one card can time two trees with the same
loop.

    python lanedetection_end2end_tpu_torch/tools/prof_conv3tap.py \\
        [--root DIR] [--dtype float32 [--batch 128]]

Run it by its path, not with `-m`, so that DIR's package is the one
imported. Prints the card's name and power limit, the check lines, and
last one JSON object: per kernel, ms a step forward and backward of the
port and of the library (bf16), or per batch and C the tile's ms a step
forward and backward (float32). Exits 1 if a check fails. Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
KEYS = ("ms", "bwd_ms", "library_ms", "bwd_library_ms")
TOL_F32 = 1e-4  # chip_smoke.py's bar for float32 planes, of max|plain|
F32_OPS = ("ldconv32::conv3tap_f32_kernel", "ldconv32::wsplit_f32_kernel")


def f32_tile_ms(smoke, dev, batch: int, reps: int = 3):
    """The float32 tile's device ms a default step at `batch`: ({C: {op:
    [forward ms, backward ms]}}, failures), op the convolution and the
    weight split (F32_OPS), each half block first held against its plain
    version."""
    import torch
    from lanedetection_end2end_tpu_torch.ops import nb_block as nb
    from lanedetection_end2end_tpu_torch.ops.tf32x3 import conv3_tf32x3
    from lanedetection_end2end_tpu_torch.utils.profiling import (
        summarize, trace)
    g = torch.Generator(device=dev).manual_seed(smoke.SEED + 2)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    out, failures = {}, []
    for half, plane, d, per_step in smoke.HALF_CASES:
        shape = (batch,) + tuple(plane[1:])
        C = shape[-1]
        x = rn(*shape)
        kh, kw = rn(3, C, C) / (3 * C) ** 0.5, rn(3, C, C) / (3 * C) ** 0.5
        bh, bw = 0.1 * rn(C), 0.1 * rn(C)
        mul = add = None
        if half == "b":
            mul = 0.5 + torch.rand(C, generator=g, device=dev)
            add = 0.1 * rn(C)
        dy, dmom = rn(*shape), 1e-3 * rn(2, C)
        with torch.no_grad():
            fwd = lambda: nb._half_fwd_cuda(x, mul, add, kh, bh, kw, bw, d)
            yout, ymid, _ = fwd()
            args = (x, mul, add, ymid, yout, dy, dmom, kh, kw, d)
            bwd = lambda: nb.half_bwd_kernel(*args)
            dx = bwd()[0]
            label = f"f32 tile nb_half_{half} {shape} d={d}"
            py = nb.half_fwd_plain(x, mul, add, kh, bh, kw, bw, d,
                                   conv=conv3_tf32x3)[0]
            pdx = nb.half_bwd_plain(*args, conv=conv3_tf32x3)[0]
            errs = [smoke.rel_err(a, b)[1] for a, b in ((yout, py),
                                                        (dx, pdx))]
            ok = max(errs) <= TOL_F32
            print(f"check {label}: y {errs[0]:.2e}, dx {errs[1]:.2e} of "
                  f"max|plain| {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(label)
            torch.cuda.synchronize()
            row = out.setdefault(C, {op: [0.0, 0.0] for op in F32_OPS})
            for i, fn in enumerate((fwd, bwd)):
                with tempfile.TemporaryDirectory() as tmp:
                    with trace(tmp):
                        for _ in range(reps):
                            fn()
                        torch.cuda.synchronize()
                    s = summarize(tmp, iters=reps)
                for op in F32_OPS:
                    row[op][i] += per_step * s.us_per_iter(op) / 1e3
    return out, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose port is timed (default: this one)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--batch", type=int, action="append", default=[],
                    help="float32: a batch to time besides 8 (repeatable)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        print("prof_conv3tap: no CUDA device", file=sys.stderr)
        return 2
    from lanedetection_end2end_tpu_torch.ops import _build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.gpu_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    if args.dtype == "float32":
        _build.build(["nb_half_fwd", "nb_half_bwd"])
        per_batch, failures = {}, []
        for batch in [8] + [b for b in args.batch if b != 8]:
            rows, f = f32_tile_ms(smoke, dev, batch)
            failures += f
            per_batch[batch] = {C: {op.split("::")[-1]: ms
                                    for op, ms in ops.items()}
                                for C, ops in sorted(rows.items())}
            total = sum(ms for ops in rows.values() for ms in
                        ops[F32_OPS[0]])
            print(f"f32 tile batch {batch}: conv3tap_f32_kernel "
                  f"{total:.4f} ms a step", flush=True)
        print(json.dumps({"card": card, "root": root, "dtype": "float32",
                          "per_step_ms": per_batch}))
        return 1 if failures else 0
    _build.build(["nb_half_fwd", "nb_half_bwd", "packed_conv"])
    g = torch.Generator(device=dev).manual_seed(smoke.SEED + 1)
    halves, failures = smoke.check_training_kernels(dev, g, torch.bfloat16)
    k11, f = smoke.check_k11(dev, g, {torch.bfloat16: "bfloat16"})
    rows = {**halves, **{n: k11[n]["bfloat16"]
                         for n in ("packed_conv_act", "packed_conv")}}
    print(json.dumps({"card": card, "root": root, "per_step_ms": {
        n: {k: s[k] for k in KEYS} for n, s in rows.items()}}))
    return 1 if failures + f else 0


if __name__ == "__main__":
    sys.exit(main())
