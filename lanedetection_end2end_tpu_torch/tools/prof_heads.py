"""Card time of K9's 2x2 head, `channel_sums` and K10 beside their one-call
library, for one checkout of the port.

At the 256x512 batch-8 shapes, in bf16 and float32 planes, each in card
time (`chip_smoke.card_ms`) and held against its plain version: K9's head
(`lane_maps_op` at k = 2, f32 logits, no moments) forward and backward at
cout 1, 2 and 4 beside `F.conv_transpose2d` (bias included) and the
transposed `aten.convolution_backward` (dx, dweight, dbias; TF32 off) on
the same operands in the planes' dtype; K10 (`head_rowsums_op`) forward
and backward at C = 1, 2 and 4; `channel_sums` at each plane of the unfused
step (`chip_smoke.SUMS_CASES`) beside `torch.var_mean(x.float(), dim=(0,
1, 2))`. The head and `channel_sums` also in device time: the card's
kernels, copies and sets of a torch.profiler trace (`device_ms`, the
measure of `chip_smoke.py --profile`), which leaves out the gaps between
launches that card time holds. What this tool adds to `chip_smoke.py` is
`--root`: the wrappers timed are those of the port in DIR (default: this
checkout), whose wrappers take the same arguments, so that one call on
one card can time two trees with the same loop.

    python lanedetection_end2end_tpu_torch/tools/prof_heads.py [--root DIR]

Run it by its path, not with `-m`, so that DIR's package is the one
imported. Prints the card's name and power limit, a line a case, and last
one JSON object: ms a call per case, and `channel_sums` ms an unfused step
(kernel and `var_mean`). Exits 1 if a result is not finite or misses its
plain version by more than 1e-2 of its largest value (the bars of
`chip_smoke.py` are tighter; this is a timing tool). Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
TOL = 1e-2
TRACED = 10  # calls in a device-time trace


def device_ms(fn, calls=TRACED):
    """-> (device ms a call of `fn`, {kernel: ms a call}): the card's
    kernels, copies and sets in one torch.profiler trace of `calls`
    calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {e.key: e.self_device_time_total / 1e3 / calls
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0}
    return sum(by.values()), by


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose port is timed (default: this one)")
    root = os.path.abspath(ap.parse_args(argv).root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("prof_heads: no CUDA device", file=sys.stderr)
        return 2
    from lanedetection_end2end_tpu_torch.ops import _build
    from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
    from lanedetection_end2end_tpu_torch.ops import packed_conv as pc
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.gpu_line()
    print(card, flush=True)
    _build.build(["lane_maps_op", "head_rowsums_op", "channel_sums"])
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(smoke.SEED + 11)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    card_ms = smoke.card_ms
    B, h, w, cin = smoke.BATCH, smoke.RESIZE // 2, smoke.RESIZE, 16
    bad, ms = [], {}

    def held(label, pairs):
        for name, got, want in pairs:
            rel = smoke.rel_err(got, want)[1]
            if not (torch.isfinite(got).all().item() and rel <= TOL):
                bad.append(f"{label} {name} {rel:.2e}")

    for dt, dname in smoke.DTYPE_NAMES.items():
        for C in (1, 2, 4):
            x = rn(B, h, w, cin).to(dt)
            wt, bias = rn(cin, C, 2, 2) / 4.0, 0.1 * rn(C)
            dy = rn(B, 2 * h, 2 * w, C)
            args = (x, None, dy, None, wt, 2)
            with torch.no_grad():
                y, _ = lm.lane_maps_op(x, wt, bias, 2, torch.float32, False)
                grads = lm.lane_maps_bwd_kernel(*args)
                held(f"head {dname} C={C}", [
                    ("y", y, lm.lane_maps_fwd_plain(x, wt, bias, 2,
                                                    torch.float32, False)[0]),
                    *zip(("dx", "dweight", "dbias"), grads,
                         lm.lane_maps_bwd_plain(*args))])
                xn, wl, bl = x.permute(0, 3, 1, 2), wt.to(dt), bias.to(dt)
                dyn = dy.to(dt).permute(0, 3, 1, 2)
                fwd = lambda: lm.lane_maps_op(x, wt, bias, 2, torch.float32,
                                              False)
                bwd = lambda: lm.lane_maps_bwd_kernel(*args)
                (d_f, k_f), (d_b, k_b) = device_ms(fwd), device_ms(bwd)
                row = {"ms": card_ms(fwd), "bwd_ms": card_ms(bwd),
                       "device_ms": d_f, "bwd_device_ms": d_b,
                       "kernels": {**k_f, **k_b},
                       "library_ms": card_ms(
                           lambda: F.conv_transpose2d(xn, wl, bl, stride=2)),
                       "bwd_library_ms": card_ms(
                           lambda: torch.ops.aten.convolution_backward(
                               dyn, xn, wl, [C], [2, 2], [0, 0], [1, 1],
                               True, [0, 0], 1, [True, True, True]))}
            ms[f"lane_maps_op head {dname} C={C}"] = row

            xs = torch.linspace(-1, 1, 2 * w, device=dev)
            zero = 16  # top rows masked, as the configs' mask does
            dS = rn(B, 2 * h, 2 * C)
            hargs = (x, dS, wt, bias, xs, zero)
            with torch.no_grad():
                held(f"head_rowsums_op {dname} C={C}", [
                    ("S", lm.head_rowsums_op(x, wt, bias, xs, zero),
                     lm.head_rowsums_fwd_plain(x, wt, bias, xs, zero)),
                    *zip(("dx", "dweight", "dbias"),
                         lm.head_rowsums_bwd_kernel(*hargs),
                         lm.head_rowsums_bwd_plain(*hargs))])
                ms[f"head_rowsums_op {dname} C={C}"] = {
                    "ms": card_ms(lambda: lm.head_rowsums_op(
                        x, wt, bias, xs, zero)),
                    "bwd_ms": card_ms(
                        lambda: lm.head_rowsums_bwd_kernel(*hargs))}

        step = {"ms": 0.0, "library_ms": 0.0}
        planes = [rn(*shape).to(dt) for shape, _ in smoke.SUMS_CASES]

        def unfused_step():
            for x, (_, per_step) in zip(planes, smoke.SUMS_CASES):
                for _ in range(per_step):
                    pc.channel_sums(x)
        with torch.no_grad():
            step["device_ms"], step["kernels"] = device_ms(unfused_step, 2)
        for shape, per_step in smoke.SUMS_CASES:
            x = rn(*shape).to(dt)
            with torch.no_grad():
                held(f"channel_sums {dname} {shape}",
                     [("sums", pc.channel_sums(x), pc.channel_sums_plain(x))])
                row = {"ms": card_ms(lambda: pc.channel_sums(x)),
                       "library_ms": card_ms(lambda: torch.var_mean(
                           x.float(), dim=(0, 1, 2)))}
            ms[f"channel_sums {dname} {shape}"] = row
            for k in ("ms", "library_ms"):
                step[k] += per_step * row[k]
        ms[f"channel_sums {dname} unfused step"] = step

    for label, row in ms.items():
        print(f"prof_heads {label}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k != "kernels"))
        for name, v in row.get("kernels", {}).items():
            print(f"prof_heads {label}:   {v:.4f} ms {name[:90]}")
    if bad:
        print("prof_heads: FAILED " + "; ".join(bad))
    print(json.dumps({"card": card, "root": root, "ms": ms}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
