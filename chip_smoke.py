#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout; exits non-zero on
any failed check and prints no result without a card. In order:

1. build the four kernels from `lanedetection_end2end_tpu_torch/csrc/`
   (one nvcc per source, all at once) and print the card's name and power
   limit;
2. hold each kernel against its plain PyTorch version on CUDA tensors at
   every shape the 256x512 serving path gives it (batch 8), plus one edge
   shape with dilation >= plane height, and time both with CUDA events;
3. serve 3 batches of 8 random 256x512 images through
   `FusedLaneNetEngine` (train_sh config, seeded random weights with
   non-trivial BatchNorm statistics), check the kernel launch counts of
   those calls and hold beta / line / horizon against the plain float32
   `LaneNet` on the card (TF32 off);
4. print the card line as nvidia-smi gives it, the kernels line, and
   `{"ok": true, "device": {...}}` last.

In the kernels line, `launches` counts the wrapper calls of the 3 engine
calls, and `ms`, `plain_ms` and `bound_ms` are per engine call (batch 8):
the sum over the path's shapes of the median time (or bound) times the
launches per call. `bound_ms` is the larger of the bytes moved (each input
read once, each output written once) over 3.35 TB/s and the FLOP of the
taps that land on the plane over 989 TFLOP/s (bf16); `library_ms` is null
because no single PyTorch call computes any of these fused functions.

Tolerances: a kernel and its plain version do the same bf16-operand,
f32-accumulate arithmetic in another summation order, so bf16 outputs may
differ by an output rounding step (2^-8 relative) and the nb1d chain of
four roundings by a few: max|diff| / max|plain| < 1e-2. The f32 row sums
of head_rowsums differ only by f32 summation order: < 1e-4. The engine
against the f32 LaneNet: the JAX package's own bars (beta max relative
error < 3e-2, line/horizon rtol = atol = 1e-2).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

RESIZE, BATCH, SEED, N_BATCHES = 256, 8, 0, 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor cores
TOL_BF16, TOL_F32 = 1e-2, 1e-4
REPLACES = {
    "nb1d": "lanedetection_end2end_tpu/ops/pallas_nb1d.py:191",
    "downsampler": "lanedetection_end2end_tpu/ops/pallas_backbone.py:155",
    "upsampler": "lanedetection_end2end_tpu/ops/pallas_backbone.py:250",
    "head_rowsums": "lanedetection_end2end_tpu/ops/pallas_backbone.py:310",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def random_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Lecun-normal conv/linear weights, small biases, BatchNorm affine and
    running statistics away from (1, 0, 0, 1) so the folding matters."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)
    uni = lambda n, lo, hi: lo + (hi - lo) * torch.rand(n, generator=g)
    sd = {}
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, torch.nn.BatchNorm2d):
            n = m.num_features
            sd.update({pre + "weight": uni(n, 0.8, 1.2),
                       pre + "bias": 0.1 * rnd(n),
                       pre + "running_mean": 0.1 * rnd(n),
                       pre + "running_var": uni(n, 0.5, 1.5),
                       pre + "num_batches_tracked": torch.tensor(0)})
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                            torch.nn.Linear)):
            w = m.weight
            fan_in = w[0].numel() if not isinstance(
                m, torch.nn.ConvTranspose2d) else w.shape[0] * w[0, 0].numel()
            sd[pre + "weight"] = rnd(*w.shape) / fan_in ** 0.5
            sd[pre + "bias"] = 0.01 * rnd(m.bias.shape[0])
    return sd


# ----------------------------------------------------------------------
# Work counts for the bound: each input read once, each output written
# once; FLOP counted for the taps that land on the plane.
# ----------------------------------------------------------------------

def nb1d_work(x, p):
    B, H, W, C = x.shape
    d = p["dilation"]
    valid = lambda n, k: n + 2 * max(0, n - k)  # taps -k, 0, +k on n rows
    taps = (valid(H, 1) * W + valid(W, 1) * H + valid(H, d) * W
            + valid(W, d) * H)
    flop = 2 * C * C * B * taps
    nbytes = 2 * x.numel() * 2 + p["w"].numel() * 2 + p["vec"].numel() * 4
    return flop, nbytes


def down_work(x, p):
    B, H, W, cin = x.shape
    cc = p["w"].shape[-1]
    Ho, Wo = H // 2, W // 2
    flop = 2 * cin * cc * B * (3 * Ho - 1) * (3 * Wo - 1)
    nbytes = (x.numel() + B * Ho * Wo * (cc + cin)) * 2 + p["w"].numel() * 2
    return flop, nbytes


def up_work(x, p):
    B, H, W, cin = x.shape
    cout = p["w"].shape[-1]
    flop = 2 * cin * cout * B * (3 * H - 1) * (3 * W - 1)
    nbytes = (x.numel() + B * 4 * H * W * cout) * 2 + p["w"].numel() * 2
    return flop, nbytes


def head_work(t, p):
    B, Hh, Wh, cin = t.shape
    C = p["w"].shape[-1]
    logits = B * (2 * Hh - p["zero_rows"]) * 2 * Wh * C
    flop = logits * (2 * cin + 5)  # conv taps + activation, squares, sums
    nbytes = t.numel() * 2 + B * 2 * Hh * 2 * C * 4 + p["w"].numel() * 2
    return flop, nbytes


def bound_ms(flop, nbytes):
    t_ops, t_bytes = flop / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lanedetection_end2end_tpu_torch.config import train_sh_config
    from lanedetection_end2end_tpu_torch.models.infer_engine import (
        FusedLaneNetEngine)
    from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
    from lanedetection_end2end_tpu_torch.ops import _build
    from lanedetection_end2end_tpu_torch.ops.backbone import (
        downsampler, downsampler_plain, head_rowsums, head_rowsums_plain,
        upsampler, upsampler_plain)
    from lanedetection_end2end_tpu_torch.ops.nb1d import nb1d, nb1d_plain

    # the f32 reference must be f32; the kernels' plain versions read
    # bf16-valued operands, exact in either mode
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_line()

    # 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    print(f"build: {len(logs)} libraries in {secs:.1f} s on {card}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # model, engine and constants (seeded random weights)
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0)
    model = LaneNet(cfg, device=dev)
    model.load_state_dict(random_state_dict(model, SEED))
    engine = FusedLaneNetEngine(cfg)
    packed = engine.prepare(model.state_dict())
    enc, dec = packed["enc"], packed["dec"]

    # 2. kernels against their plain versions ---------------------------
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    act = lambda *s: torch.randn(*s, generator=g, device=dev).to(
        torch.bfloat16)
    B, H, W = BATCH, RESIZE, 2 * RESIZE
    # (kernel, wrapper, plain, work, input, constants, launches per call)
    cases = [
        ("downsampler", downsampler, downsampler_plain, down_work,
         act(B, H, W, 3), enc["initial"], 1),
        ("downsampler", downsampler, downsampler_plain, down_work,
         act(B, H // 2, W // 2, 16), enc["down1"], 1),
        ("downsampler", downsampler, downsampler_plain, down_work,
         act(B, H // 4, W // 4, 64), enc["down2"], 1),
        ("nb1d", nb1d, nb1d_plain, nb1d_work,
         act(B, H // 4, W // 4, 64), enc["nb64"][0], 7),
    ]
    for i, d in enumerate((2, 4, 8, 16)):
        cases.append(("nb1d", nb1d, nb1d_plain, nb1d_work,
                      act(B, H // 8, W // 8, 128), enc["nb128"][i], 2))
    cases += [
        ("nb1d", nb1d, nb1d_plain, nb1d_work,
         act(B, H // 2, W // 2, 16), dec["nb16"][0], 2),
        ("upsampler", upsampler, upsampler_plain, up_work,
         act(B, H // 8, W // 8, 128), dec["up1"], 1),
        ("upsampler", upsampler, upsampler_plain, up_work,
         act(B, H // 4, W // 4, 64), dec["up2"], 1),
        ("head_rowsums", head_rowsums, head_rowsums_plain, head_work,
         act(B, H // 2, W // 2, 16), dec["head"], 1),
        # edge: the resize=64 NB1D-128 plane (8x16) with d = 16 >= H, W
        ("nb1d", nb1d, nb1d_plain, nb1d_work,
         act(2, 8, 16, 128), enc["nb128"][3], 0),
    ]
    summary = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "ops_ms": 0.0, "flop": 0}
               for n in REPLACES}
    failures = []
    for name, wrapper, plain, work, x, p, per_call in cases:
        got = wrapper(x, p)
        torch.cuda.synchronize()
        want = plain(x, p)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = TOL_F32 if got.dtype == torch.float32 else TOL_BF16
        ok = (got.shape == want.shape and got.dtype == want.dtype
              and torch.isfinite(got).all().item() and err <= tol * scale)
        k_ms = median_ms(lambda: wrapper(x, p))
        p_ms = median_ms(lambda: plain(x, p))
        flop, nbytes = work(x, p)
        b_ms, by = bound_ms(flop, nbytes)
        label = f"{name}{tuple(x.shape)}" + (
            f" d={p['dilation']}" if "dilation" in p else "")
        print(f"check {label}: max|diff|={err:.3e} (tol {tol:g} x "
              f"max|plain| {scale:.3e}) {'ok' if ok else 'FAIL'}; "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({by}); x{per_call} per engine call")
        if not ok:
            failures.append(label)
        s = summary[name]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["ms"] += per_call * k_ms
        s["plain_ms"] += per_call * p_ms
        s["bound_ms"] += per_call * b_ms
        s["ops_ms"] += per_call * b_ms * (by == "operations")
        s["flop"] += per_call * flop
    if failures:
        fail("kernel disagrees with its plain version: "
             + ", ".join(failures))
    per_image = {n: s["flop"] / BATCH / 1e9 for n, s in summary.items()}
    print("backbone work per 256x512 image: "
          + ", ".join(f"{n} {g:.3f}" for n, g in per_image.items())
          + f", total {sum(per_image.values()):.3f} GFLOP")

    # 3. engine run -----------------------------------------------------
    gi = torch.Generator(device=dev).manual_seed(SEED + 2)
    images = torch.rand(N_BATCHES, BATCH, H, W, 3, generator=gi, device=dev)
    engine(packed, images[0])  # warm-up (cuDNN plans of the bf16 heads)
    torch.cuda.synchronize()
    wrappers = {"nb1d": nb1d, "downsampler": downsampler,
                "upsampler": upsampler, "head_rowsums": head_rowsums}
    for w in wrappers.values():
        w.launches = 0
    outs, batch_ms = [], []
    for i in range(N_BATCHES):
        t0 = time.perf_counter()
        outs.append(engine(packed, images[i]))
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - t0))
    launches = {n: w.launches for n, w in wrappers.items()}
    expected = {"nb1d": 17, "downsampler": 3, "upsampler": 2,
                "head_rowsums": 1}
    print(f"engine launches over {N_BATCHES} calls: {launches}")
    for n, per in expected.items():
        if launches[n] != N_BATCHES * per:
            fail(f"{n}: {launches[n]} launches, expected "
                 f"{N_BATCHES * per}")

    worst = {"beta": 0.0, "line": 0.0, "horizon": 0.0}
    C = cfg.out_channels
    for i, (beta, line, hor) in enumerate(outs):
        ref = model(images[i])
        if (tuple(beta.shape) != (BATCH, C, cfg.order + 1)
                or tuple(line.shape) != (BATCH, 4)
                or tuple(hor.shape) != (BATCH, RESIZE)):
            fail(f"output shapes {beta.shape} {line.shape} {hor.shape}")
        for t in (beta, line, hor):
            if not torch.isfinite(t).all():
                fail("non-finite engine output")
        rel = ((beta - ref.beta).abs().max()
               / ref.beta.abs().max()).item()
        worst["beta"] = max(worst["beta"], rel)
        for key, a, b in (("line", line, ref.line_logits),
                          ("horizon", hor, ref.horizon_logits)):
            excess = ((a - b).abs() - (1e-2 + 1e-2 * b.abs())).max().item()
            worst[key] = max(worst[key], (a - b).abs().max().item())
            if excess > 0:
                fail(f"{key} logits off the f32 LaneNet by "
                     f"{(a - b).abs().max().item():.3e}")
        if rel >= 3e-2:
            fail(f"beta relative error {rel:.3e} >= 3e-2")
    ms = statistics.median(batch_ms)
    print(f"engine vs f32 LaneNet: beta max rel {worst['beta']:.3e}, line "
          f"max|diff| {worst['line']:.3e}, horizon max|diff| "
          f"{worst['horizon']:.3e}")
    print(f"engine: {ms:.3f} ms per batch of {BATCH} (median of "
          f"{N_BATCHES}: {', '.join(f'{t:.3f}' for t in batch_ms)}), "
          f"{1e3 * BATCH / ms:.1f} images/s")

    # 4. kernels line and result ----------------------------------------
    kernels = []
    for n, s in summary.items():
        kernels.append({
            "name": n, "route": "cuda",
            "source": f"lanedetection_end2end_tpu_torch/csrc/{n}.cu",
            "replaces": REPLACES[n], "launches": launches[n],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": ("operations" if 2 * s["ops_ms"] > s["bound_ms"]
                         else "bytes"),
            "library_ms": None})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
