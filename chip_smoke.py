#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

`--profile` also traces two more train steps of each configuration
(`fused_maps` on, the default, and off) with torch.profiler and prints the
card's busy time per step and its largest kernels. Needs one
CUDA card, nvcc and the repository checkout; exits non-zero on
any failed check and prints no result without a card. In order:

1. build the ten kernel libraries from
   `lanedetection_end2end_tpu_torch/csrc/` (one nvcc per source, all at
   once) and print the card's name and power limit;
2. hold each serving kernel against its plain PyTorch version on CUDA
   tensors at every shape the 256x512 serving path gives it (batch 8),
   plus one edge shape with dilation >= plane height, and time both with
   CUDA events;
2b. the same for the training kernels: forward and backward of
   `nb_half_a` and `nb_half_b` at every (C, d, plane) of the 256x512 train
   step at batch 8 plus the d >= H edge, `channel_sums` at its five
   shapes, and the stride-2 ops at their seven: `downsampler_op` x3 (inputs
   with planted pooling ties, the input gradient required at all three),
   `lane_maps_op` x3 (the two upsamplers with moments, the head with f32
   output and none) and `head_rowsums_op`; then one whole NB1D block per
   (C, d) and every downsampler and upsampler block forward and backward
   through autograd, on the kernels and on their plain versions;
3. serve 3 batches of 8 random 256x512 images through
   `FusedLaneNetEngine` (train_sh config, seeded random weights with
   non-trivial BatchNorm statistics), check the kernel launch counts of
   those calls and hold beta / line / horizon against the plain float32
   `LaneNet` on the card (TF32 off);
4. take e2e train steps through `make_train_step` (same config with
   compute_dtype bfloat16, adam, seeded random weights, a seeded synthetic
   batch of 8): first one step with dropout off on the kernels and the
   same step on the plain versions on the card (see below), one eval
   step with its launches counted (the head on `lane_maps_op`, no fused
   tail), then, from the seeded weights and with the launch counts set to
   0, 3 steps with dropout on in the default configuration
   (`fused_maps=True`): per step exactly 17 launches of each of nb_half_a
   / nb_half_b forward and backward, 3 + 3 of downsampler_op, 2 + 2 of
   lane_maps_op, 1 + 1 of head_rowsums_op and 0 of channel_sums, no call
   of `F.conv_transpose2d` and only the heads' `F.conv2d` / `F.max_pool2d`,
   no logits plane, finite loss and gradients, parameters moved; then,
   counted anew, one step with `fused_maps=False` (17 / 17 / 17 / 17 and 5
   of channel_sums), which keeps that path and `channel_sums` driven;
5. print the card line as nvidia-smi gives it, the kernels line, and
   `{"ok": true, "device": {...}}` last.

In the kernels line, `launches` counts the wrapper calls of the 3 engine
calls (serving kernels) or of the 3 default train steps (training
kernels, with `bwd_launches` beside it; for `channel_sums` of the one
`fused_maps=False` step), and `ms`, `plain_ms` and `bound_ms` are per
engine call or per train step (batch 8): the sum over the path's shapes of
the median time (or bound) times the launches per call. The training
kernels carry the same numbers for their backward as `bwd_ms`,
`plain_bwd_ms`, `bwd_bound_ms`. `bound_ms` is the larger of the bytes
moved (each input read once, each output written once: 3 planes for a
half block's forward, 5 for its backward; x and y for a stride-2 op's
forward, x, y, dy and dx for its backward) over 3.35 TB/s and the FLOP of
the taps that land on the plane over 989 TFLOP/s (bf16); `library_ms` is
null where no single PyTorch call computes the fused function, for
channel_sums the time of `torch.var_mean(x.float(), dim=(0, 1, 2))`, which
gives the same statistics, and for lane_maps_op the time of one
`F.conv_transpose2d` on the same bf16 operands at the head's shape, where
the op takes no moments (`library_of`; the kernel's own time at that shape,
which no train step runs, is `ms_at_library_shape`). Neither is used in
the port.

Tolerances: a kernel and its plain version do the same bf16-operand,
f32-accumulate arithmetic in another summation order, so bf16 outputs may
differ by an output rounding step (2^-8 relative) and the nb1d chain of
four roundings by a few: max|diff| / max|plain| < 1e-2. The f32 row sums
of head_rowsums differ only by f32 summation order: < 1e-4. The engine
against the f32 LaneNet: the JAX package's own bars (beta max relative
error < 3e-2, line/horizon rtol = atol = 1e-2). The training kernels'
f32 reductions (moments, dk, db, dmul, dadd) sum bf16-exact products in
another order, with atomics, over operands of which a few may differ from
the plain version's by one bf16 step: max|diff| / max|plain| < 2e-3. The
stride-2 ops have no relu inside and their pool routing is a function of
the input alone, so the same bars hold for them without exception, planted
ties included; the row sums S of head_rowsums_op at 1e-4, and bit for bit
against a second launch.

A whole block through autograd has two independent forwards, so a relu
whose argument lies within a rounding step of zero may open on one side
only, and a flipped element passes or drops a whole element of dx (0.1-0.2
of max, in the kernels against their own rerun too). The block's output
and new running statistics, where nothing flips, are held at 2e-2 of
max|plain| (one bf16 step in the top binade is 2^-7 of max, and the output
is rounded three more times after the kernels). dx and every parameter
gradient are held by direction and size: cosine > 0.999 and norm ratio in
0.99-1.01, and for dx fewer than 2e-3 of the elements off by more than
2e-2 of max. The biases of the two 1x3 convolutions sit ahead of a train-mode
BatchNorm, as does a downsampler's or upsampler's convolution bias, so
their true gradient is 0 and what either side computes is
rounding noise: the kernels' value is held against 0, at 2e-2 of the
block's largest parameter gradient (a backward that dropped the moment
cotangent would leave the sum of dy there, as large as the largest).

The train step on the kernels against the step on the plain versions, on
the seeded weights as drawn: loss within 1e-2 relative, and for the four
leaves of the heads' last linear layers, which see the encoder's features
directly, gradient cosine > 0.98 and norm ratio in 0.9-1.1. No tighter bar
holds on these weights. In bf16, through 40 train-mode BatchNorms on
random weights, the step is so sensitive that the kernel step does not
reproduce itself from run to run (its f32 atomics change last bits, a few
bf16 roundings flip downstream): measured on an H100, its loss moves by
1e-3 and those leaves by up to 0.005 in cosine and 0.025 in norm between
runs; the decoder's output convolution, whose gradient is the residue of
a cancelling sum over every pixel through the cubic fit, reads cosine
0.87-0.88 against the plain step; and the whole gradient reads 0.24, as it
does for the kernel step against its own rerun (0.28) and for the plain
step when one input pixel changes by 1/255 (0.28). So for the whole
gradient the script damps the residual branches (every NB1D block's
second BatchNorm scale times BN2_DAMP), which tames that sensitivity,
measures the plain step's own cosine under that one-pixel change as the
yardstick, and requires the kernels' cosine against the plain step to be
above 0.9 and no more than 0.02 below the yardstick, with the norm ratio
in 0.98-1.02. The kernels' arithmetic itself is held tightly in phase 2b,
where both versions read the same inputs.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

RESIZE, BATCH, SEED, N_BATCHES = 256, 8, 0, 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor cores
TOL_BF16, TOL_F32, TOL_REDUCE, TOL_BLOCK = 1e-2, 1e-4, 2e-3, 2e-2
TRAIN_STEPS = 3
BN2_DAMP = 0.1  # scale of bn2.weight for the whole-gradient comparison
# kernels against plain versions through autograd: least gradient cosine
# over one block, largest share of dx that relu flips may move, and least
# cosine for the heads' last layers over a whole step on the seeded weights
COS_NEAR, MAX_FLIPS, COS_HEADS = 0.999, 2e-3, 0.98
NEAR_LOSS = ("line_classification.fully_connected_line1.",
             "horizon_estimation.fully_connected_horizon.")
SHOWN = ("net.decoder.output_conv.",)
REPLACES = {
    "nb1d": "lanedetection_end2end_tpu/ops/pallas_nb1d.py:191",
    "downsampler": "lanedetection_end2end_tpu/ops/pallas_backbone.py:155",
    "upsampler": "lanedetection_end2end_tpu/ops/pallas_backbone.py:250",
    "head_rowsums": "lanedetection_end2end_tpu/ops/pallas_backbone.py:310",
    "nb_half_a": "lanedetection_end2end_tpu/ops/pallas_nb_block.py:198",
    "nb_half_b": "lanedetection_end2end_tpu/ops/pallas_nb_block.py:321",
    "channel_sums": "lanedetection_end2end_tpu/ops/pallas_packed_conv.py:290",
    "downsampler_op": "lanedetection_end2end_tpu/ops/pallas_lanemaps.py:371",
    "lane_maps_op": "lanedetection_end2end_tpu/ops/pallas_lanemaps.py:167",
    "head_rowsums_op": "lanedetection_end2end_tpu/ops/pallas_lanemaps.py:547",
}
# kernel -> (forward source, backward source) where they are not `name`.cu
SOURCES = {
    "nb_half_a": ("nb_half_fwd.cu", "nb_half_bwd.cu"),
    "nb_half_b": ("nb_half_fwd.cu", "nb_half_bwd.cu"),
    "downsampler_op": ("downsampler_op.cu", "downsampler_op.cu"),
    "lane_maps_op": ("lane_maps_op.cu", "lane_maps_op.cu"),
    "head_rowsums_op": ("head_rowsums_op.cu", "head_rowsums_op.cu"),
}
SERVING = ("nb1d", "downsampler", "upsampler", "head_rowsums")
CSRC = "lanedetection_end2end_tpu_torch/csrc/"


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


def half_work(shape, d, backward):
    """One half block: two 3-tap convolutions forward; their two input
    gradients and two weight gradients backward."""
    B, H, W, C = shape
    valid = lambda n, k: n + 2 * max(0, n - k)
    taps = valid(H, d) * W + valid(W, d) * H
    flop = 2 * C * C * B * taps * (2 if backward else 1)
    plane = 2 * B * H * W * C
    small = 2 * 3 * C * C * (4 if backward else 2) + 4 * 6 * C
    return flop, (5 if backward else 3) * plane + small


def sums_work(shape):
    n = 1
    for v in shape:
        n *= v
    return 3 * n, 2 * n + 8 * shape[-1]


def rel_err(got, want):
    """(max|diff|, max|diff| / max|want|) in f32."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


@contextlib.contextmanager
def plain_versions():
    """The training backbone on the kernels' plain versions, for a
    comparison on the card: nothing else calls them there."""
    from lanedetection_end2end_tpu_torch.ops import nb_block as nb
    from lanedetection_end2end_tpu_torch.ops import packed_conv as pc
    from lanedetection_end2end_tpu_torch.ops import packed_graph
    from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
    plain = {"nb_half_a": nb.nb_half_a_plain, "nb_half_b": nb.nb_half_b_plain,
             "channel_sums": pc.channel_sums_plain,
             "downsampler_op": lm.downsampler_fwd_plain,
             "lane_maps_op": lm.lane_maps_fwd_plain,
             "head_rowsums_op": lm.head_rowsums_fwd_plain}
    kernels = {name: getattr(packed_graph, name) for name in plain}
    for name, fn in plain.items():
        setattr(packed_graph, name, fn)
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(packed_graph, name, fn)


@contextlib.contextmanager
def count_calls(module, names):
    """Count the calls of `module`'s functions `names` -> {name: calls}."""
    calls = dict.fromkeys(names, 0)
    originals = {n: getattr(module, n) for n in names}

    def counting(n):
        def call(*args, **kwargs):
            calls[n] += 1
            return originals[n](*args, **kwargs)
        return call
    for n in names:
        setattr(module, n, counting(n))
    try:
        yield calls
    finally:
        for n, fn in originals.items():
            setattr(module, n, fn)


def check_blocks_through_autograd(dev, g, net):
    """Phase 2b, second part: one whole NB1D block of `net` per (C, d) of
    the train step, forward and backward through autograd
    (`packed_graph.nb1d_train`: both halves, the BatchNorm math between
    them with its moment gradient, the residual), and every downsampler and
    upsampler block (`downsampler_train`, `upsampler_train`: the op, the
    BatchNorm from its moments, relu), on the kernels and on their plain
    versions. Returns the failures."""
    from lanedetection_end2end_tpu_torch.ops.packed_graph import (
        downsampler_train, nb1d_train, upsampler_train)

    hw = {3: (RESIZE, 2 * RESIZE), 16: (RESIZE // 2, RESIZE),
          64: (RESIZE // 4, RESIZE // 2), 128: (RESIZE // 8, RESIZE // 4)}
    # label -> (block, its function, input channels, output plane); the
    # biases named by `zero` sit ahead of a train-mode BatchNorm
    cases = {}
    for m in net.modules():
        if hasattr(m, "conv3x1_1"):
            C, d = m.bn1.num_features, m.conv3x1_2.dilation[0]
            cases.setdefault(f"nb1d block C={C} d={d}",
                             (m, nb1d_train, C, (*hw[C], C)))
        elif hasattr(m, "conv") and hasattr(m, "bn"):
            cin, cout = m.conv.in_channels, m.bn.num_features
            down = isinstance(m.conv, torch.nn.Conv2d)
            h, w = hw[cin]
            cases[f"{'down' if down else 'up'}sampler block {cin}->{cout}"] = (
                m, downsampler_train if down else upsampler_train, cin,
                (h // 2, w // 2, cout) if down else (2 * h, 2 * w, cout))
    zero = ("d conv1x3_1.bias", "d conv1x3_2.bias", "d conv.bias")
    failures = []
    for name, (block, fn, cin, out_plane) in sorted(cases.items()):
        shape = (BATCH, *hw[cin], cin)
        x0 = torch.relu(torch.randn(*shape, generator=g, device=dev)).to(
            torch.bfloat16)
        dy = torch.randn(BATCH, *out_plane, generator=g, device=dev).to(
            torch.bfloat16)
        stats = {k: v.clone() for k, v in block.state_dict().items()}

        def run():
            block.load_state_dict(stats)
            block.zero_grad(set_to_none=True)
            x = x0.clone().requires_grad_(True)
            y = fn(x, block, train=True)
            y.backward(dy)
            torch.cuda.synchronize()
            out = {"y": y.detach(), "dx": x.grad}
            out.update({f"d {k}": p.grad for k, p in block.named_parameters()})
            out.update({k: v.clone() for k, v in block.named_buffers()
                        if k.startswith("bn") and "running" in k})
            return out

        got = run()
        with plain_versions():
            want = run()
        block.load_state_dict(stats)
        block.zero_grad(set_to_none=True)
        # a bias ahead of a train-mode BatchNorm: its true gradient is 0,
        # through the moment cotangent
        gmax = max(v.abs().max().item() for k, v in got.items()
                   if k.startswith("d "))
        bad, worst_cos, worst_flips = [], 1.0, 0.0
        for k, w in want.items():
            a, b = got[k].double().flatten(), w.double().flatten()
            diff, scale = (a - b).abs(), max(b.abs().max().item(), 1e-30)
            if not torch.isfinite(a).all().item():
                bad.append(f"{k} not finite")
            elif k in zero:
                if a.abs().max().item() > TOL_BLOCK * gmax:
                    bad.append(f"{k} max {a.abs().max().item():.3g} > "
                               f"{TOL_BLOCK:g} x {gmax:.3g}")
            elif k == "y" or "running" in k:
                if diff.max().item() > TOL_BLOCK * scale:
                    bad.append(f"{k} rel {diff.max().item() / scale:.2e} > "
                               f"{TOL_BLOCK:g}")
            else:
                cos = (torch.dot(a, b) / (a.norm() * b.norm())).item()
                ratio = (a.norm() / b.norm()).item()
                # only a plane has elements that a single relu flip moves
                flips = ((diff > TOL_BLOCK * scale).float().mean().item()
                         if k == "dx" else 0.0)
                worst_cos = min(worst_cos, cos)
                worst_flips = max(worst_flips, flips)
                if not (cos > COS_NEAR and 0.99 < ratio < 1.01
                        and flips < MAX_FLIPS):
                    bad.append(f"{k} cosine {cos:.6f} ratio {ratio:.5f} "
                               f"off elements {flips:.2e}")
        label = f"{name} {shape} through autograd"
        print(f"check {label}: {len(want)} tensors (output, dx, parameter "
              f"gradients, new running statistics), least cosine "
              f"{worst_cos:.6f}, share of dx off by more than "
              f"{TOL_BLOCK:g} x max {worst_flips:.2e}: "
              + ("ok" if not bad else "FAIL " + "; ".join(bad)))
        if bad:
            failures.append(f"{label}: " + ", ".join(bad))
    return failures


def hold(label, pairs, s, failures):
    """Hold kernel results against plain ones; pairs: (name, kernel result,
    plain result). bf16 planes at TOL_BF16 of max|plain|, f32 results at
    TOL_REDUCE (`tol_f32` overrides it). Records the worst errors in `s`,
    appends to `failures`, returns the verdict for the check line."""
    bad = []
    for name, got, want, *tol_f32 in pairs:
        err, rel = rel_err(got, want)
        reduce = got.dtype == torch.float32
        tol = (tol_f32[0] if tol_f32 else TOL_REDUCE) if reduce else TOL_BF16
        if reduce:
            s["max_rel_err_reduce"] = max(s["max_rel_err_reduce"], rel)
            s["max_abs_err_reduce"] = max(s["max_abs_err_reduce"], err)
        else:
            s["max_abs_err"] = max(s["max_abs_err"], err)
        if (got.shape != want.shape or got.dtype != want.dtype
                or not torch.isfinite(got).all().item() or rel > tol):
            bad.append(f"{name} rel {rel:.2e} > {tol:g}")
    if bad:
        failures.append(f"{label}: " + ", ".join(bad))
    return "ok" if not bad else "FAIL " + "; ".join(bad)


TRAIN_KEYS = ("ms", "plain_ms", "bound_ms", "ops_ms", "bwd_ms",
              "plain_bwd_ms", "bwd_bound_ms", "max_abs_err",
              "max_abs_err_reduce", "max_rel_err_reduce")


def time_and_record(label, s, per_step, verdict, fwd, pfwd, bwd, pbwd, work):
    """Time a training kernel's forward and backward and their plain
    versions (medians), compute both bounds from `work(backward)` ->
    (flop, bytes), print the check line and add `per_step` times each
    number to the summary `s`. Returns the forward's ms."""
    with torch.no_grad():
        f_ms, pf_ms = median_ms(fwd), median_ms(pfwd)
        pb_ms, b_ms = median_ms(pbwd), median_ms(bwd)
    fb, f_by = bound_ms(*work(False))
    bb, b_by = bound_ms(*work(True))
    print(f"check {label}: {verdict}; forward {f_ms:.4f} ms (plain "
          f"{pf_ms:.4f}, bound {fb:.4f} {f_by}), backward {b_ms:.4f} ms "
          f"(plain {pb_ms:.4f}, bound {bb:.4f} {b_by}); x{per_step} per "
          f"train step")
    for key, v in (("ms", f_ms), ("plain_ms", pf_ms), ("bound_ms", fb),
                   ("ops_ms", fb * (f_by == "operations")),
                   ("bwd_ms", b_ms), ("plain_bwd_ms", pb_ms),
                   ("bwd_bound_ms", bb)):
        s[key] += per_step * v
    return f_ms


def check_training_kernels(dev, g):
    """Phase 2b. Returns ({name: summary}, failures)."""
    from lanedetection_end2end_tpu_torch.ops import nb_block as nb
    from lanedetection_end2end_tpu_torch.ops.packed_conv import (
        channel_sums, channel_sums_plain)

    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    B, H, W = BATCH, RESIZE, 2 * RESIZE
    p64, p128, p16 = ((B, H // 4, W // 4, 64), (B, H // 8, W // 8, 128),
                      (B, H // 2, W // 2, 16))
    # (half, plane, d, launches per train step)
    cases = [("a", p64, 1, 7), ("a", p128, 1, 8), ("a", p16, 1, 2),
             ("b", p64, 1, 7), ("b", p16, 1, 2)]
    cases += [("b", p128, d, 2) for d in (2, 4, 8, 16)]
    # edge: the resize=64 NB1D-128 plane (8x16) with d = 16 >= H, W
    cases += [("a", (2, 8, 16, 128), 1, 0), ("b", (2, 8, 16, 128), 16, 0)]
    summary = {n: dict.fromkeys(TRAIN_KEYS, 0.0)
               for n in ("nb_half_a", "nb_half_b", "channel_sums")}
    failures = []

    for half, shape, d, per_step in cases:
        C = shape[-1]
        wrapper = nb.nb_half_a if half == "a" else nb.nb_half_b
        s = summary[wrapper.__name__]
        x = rn(*shape).to(torch.bfloat16)
        kh, kw = rn(3, C, C) / (3 * C) ** 0.5, rn(3, C, C) / (3 * C) ** 0.5
        bh, bw = 0.1 * rn(C), 0.1 * rn(C)
        mul = add = None
        if half == "b":
            mul = 0.5 + torch.rand(C, generator=g, device=dev)
            add = 0.1 * rn(C)
        dy, dmom = rn(*shape).to(torch.bfloat16), 1e-3 * rn(2, C)
        call = ((lambda: wrapper(x, kh, bh, kw, bw)) if half == "a" else
                (lambda: wrapper(x, mul, add, kh, bh, kw, bw, d)))
        with torch.no_grad():
            y, mom = call()
            torch.cuda.synchronize()
            py, pmid, pmom = nb.half_fwd_plain(x, mul, add, kh, bh, kw, bw, d)
            # the backward kernels and their plain version on the same
            # inputs: the plain forward's stashes
            bwd_args = (x, mul, add, pmid, py, dy, dmom, kh, kw, d)
            grads = [t for t in nb.half_bwd_kernel(*bwd_args)
                     if t is not None]
            torch.cuda.synchronize()
            pgrads = [t for t in nb.half_bwd_plain(*bwd_args)
                      if t is not None]
        names = ["dx"] + (["dmul", "dadd"] if half == "b" else []) + [
            "dkh", "dbh", "dkw", "dbw"]
        label = f"nb_half_{half}{shape} d={d}"
        verdict = hold(label, [("y", y, py), ("mom", mom, pmom)]
                       + list(zip(names, grads, pgrads)), s, failures)
        time_and_record(
            label, s, per_step, verdict, call,
            lambda: nb.half_fwd_plain(x, mul, add, kh, bh, kw, bw, d),
            lambda: nb.half_bwd_kernel(*bwd_args),
            lambda: nb.half_bwd_plain(*bwd_args),
            lambda bwd: half_work(shape, d, bwd))

    s = summary["channel_sums"]
    s["library_ms"] = 0.0
    for shape in (p16, p64, p128, p64, p16):  # down x3, up x2
        x = rn(*shape).to(torch.bfloat16)
        got = channel_sums(x)
        torch.cuda.synchronize()
        label = f"channel_sums{shape}"
        verdict = hold(label, [("sums", got, channel_sums_plain(x))], s,
                       failures)
        k_ms = median_ms(lambda: channel_sums(x))
        p_ms = median_ms(lambda: channel_sums_plain(x))
        l_ms = median_ms(lambda: torch.var_mean(x.float(), dim=(0, 1, 2)))
        b_ms, by = bound_ms(*sums_work(shape))
        print(f"check {label}: {verdict}; kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, var_mean {l_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({by})")
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms),
                       ("library_ms", l_ms)):
            s[key] += v
    s["max_abs_err"] = s["max_abs_err_reduce"]  # its only outputs are f32
    return summary, failures


def s2_work(small_pixels, cs, cl, k, planes_bytes, backward):
    """A stride-2 op on `small_pixels` = (B, Hs, Ws): the taps of a k x k
    kernel between cs and cl channels that land on the plane (twice
    backward: the input and the weight gradient), and the bytes of its
    planes (`planes_bytes`: (forward, backward)) plus the weights."""
    B, Hs, Ws = small_pixels
    taps = ((3 * Hs - 1) * (3 * Ws - 1) if k == 3 else 4 * Hs * Ws)
    flop = 2 * cs * cl * B * taps * (2 if backward else 1)
    return flop, (planes_bytes[backward]
                  + cs * cl * k * k * (6 if backward else 2))


def plant_pool_ties(x):
    """Every fourth 2x2 window in each direction gets an exact tie between
    two non-zero maxima at (row 1, col 0) and (row 0, col 1), which the
    where-chain and a row-major argmax route differently; relu'd inputs
    bring the all-zero windows."""
    x[:, 0::8, 0::8] = 0.5
    x[:, 1::8, 1::8] = 0.5
    x[:, 0::8, 1::8] = 3.0
    x[:, 1::8, 0::8] = 3.0
    return x


def check_lanemap_kernels(dev, g):
    """Phase 2b, the stride-2 training ops: `downsampler_op`, `lane_maps_op`
    and `head_rowsums_op`, forward and backward (the backward kernels and
    their plain version on the same stashes, with a non-zero moment
    cotangent), at every shape of the 256x512 train and eval steps.
    Returns ({name: summary}, failures)."""
    import torch.nn.functional as F

    from lanedetection_end2end_tpu_torch.config import train_sh_config
    from lanedetection_end2end_tpu_torch.models.lanenet import (
        make_fitter, zero_rows)
    from lanedetection_end2end_tpu_torch.ops import lanemaps as lm

    bf = torch.bfloat16
    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    B, H, W = BATCH, RESIZE, 2 * RESIZE
    summary = {n: dict.fromkeys(TRAIN_KEYS, 0.0) for n in
               ("downsampler_op", "lane_maps_op", "head_rowsums_op")}
    failures = []

    # K8: the three downsamplers, planted ties, dx required at all three
    s = summary["downsampler_op"]
    for (h, w, cin), cout in (((H, W, 3), 16), ((H // 2, W // 2, 16), 64),
                              ((H // 4, W // 4, 64), 128)):
        cc = cout - cin
        x = plant_pool_ties(torch.relu(rn(B, h, w, cin))).to(bf)
        wt, bias = rn(cc, cin, 3, 3) / (9 * cin) ** 0.5, 0.1 * rn(cc)
        dy, dmom = rn(B, h // 2, w // 2, cout).to(bf), 1e-3 * rn(2, cout)
        with torch.no_grad():
            y, mom = lm.downsampler_op(x, wt, bias)
            torch.cuda.synchronize()
            py, pmom = lm.downsampler_fwd_plain(x, wt, bias)
            args = (x, py, dy, dmom, wt)
            grads = lm.downsampler_bwd_kernel(*args)
            torch.cuda.synchronize()
            pgrads = lm.downsampler_bwd_plain(*args)
            nodx = lm.downsampler_bwd_kernel(*args, need_dx=False)
        label = f"downsampler_op{tuple(x.shape)}->{cout}"
        verdict = hold(label, [("y", y, py), ("mom", mom, pmom)] + list(zip(
            ("dx", "dweight", "dbias"), grads, pgrads)) + [
            ("dweight without dx", nodx[1], pgrads[1])], s, failures)
        if nodx[0] is not None:
            failures.append(f"{label}: dx returned though not needed")
        # forward: x read, y written; backward: x, y, dy read, dx written
        planes = (2 * (x.numel() + y.numel()), 4 * (x.numel() + y.numel()))
        time_and_record(
            label, s, 1, verdict,
            lambda: lm.downsampler_op(x, wt, bias),
            lambda: lm.downsampler_fwd_plain(x, wt, bias),
            lambda: lm.downsampler_bwd_kernel(*args),
            lambda: lm.downsampler_bwd_plain(*args),
            lambda bwd: s2_work((B, h // 2, w // 2), cc, cin, 3, planes, bwd))

    # K9: the two upsamplers (bf16 out, moments) and the head as the eval
    # step runs it (f32 out, no moments)
    s = summary["lane_maps_op"]
    for (h, w, cin), cout, k, out_dtype, want_mom, per_step in (
            ((H // 8, W // 8, 128), 64, 3, bf, True, 1),
            ((H // 4, W // 4, 64), 16, 3, bf, True, 1),
            ((H // 2, W // 2, 16), 4, 2, torch.float32, False, 0)):
        x = rn(B, h, w, cin).to(bf)
        wt = rn(cin, cout, k, k) / (k * k * cin / 4) ** 0.5
        bias = 0.1 * rn(cout)
        dy = rn(B, 2 * h, 2 * w, cout).to(out_dtype)
        dmom = 1e-3 * rn(2, cout) if want_mom else None
        op = lambda: lm.lane_maps_op(x, wt, bias, k, out_dtype, want_mom)
        plain = lambda: lm.lane_maps_fwd_plain(x, wt, bias, k, out_dtype,
                                               want_mom)
        with torch.no_grad():
            y, mom = op()
            torch.cuda.synchronize()
            py, pmom = plain()
            args = (x, py if want_mom else None, dy, dmom, wt, k)
            grads = lm.lane_maps_bwd_kernel(*args)
            torch.cuda.synchronize()
            pgrads = lm.lane_maps_bwd_plain(*args)
        label = (f"lane_maps_op{tuple(x.shape)}->{cout} k={k} "
                 f"{str(out_dtype).split('.')[-1]}"
                 + ("" if want_mom else " no moments"))
        pairs = [("y", y, py)] + ([("mom", mom, pmom)] if want_mom else [])
        verdict = hold(label, pairs + list(zip(
            ("dx", "dweight", "dbias"), grads, pgrads)), s, failures)
        if (mom is None) != (not want_mom):
            failures.append(f"{label}: moments returned {mom is not None}")
        ybytes = y.numel() * y.element_size()
        # backward reads y only to fold the moment cotangent
        planes = (2 * x.numel() + ybytes,
                  4 * x.numel() + ybytes * (1 + want_mom))
        f_ms = time_and_record(
            label, s, per_step, verdict, op, plain,
            lambda: lm.lane_maps_bwd_kernel(*args),
            lambda: lm.lane_maps_bwd_plain(*args),
            lambda bwd: s2_work((B, h, w), cin, cout, k, planes, bwd))
        if not want_mom:
            # one PyTorch call on the same bf16 operands (its output is
            # bf16, the op's f32); timed here, used nowhere in the port
            xn = x.permute(0, 3, 1, 2)
            wb, bb = wt.to(bf), bias.to(bf)
            with torch.no_grad():
                s["library_ms"] = median_ms(
                    lambda: F.conv_transpose2d(xn, wb, bb, stride=2))
            s["library_of"] = label
            s["ms_at_library_shape"] = f_ms
            print(f"check {label}: F.conv_transpose2d on the same bf16 "
                  f"operands {s['library_ms']:.4f} ms")

    # K10: the fused tail, with the fitter's column coordinate and mask
    s = summary["head_rowsums_op"]
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0)
    xs = make_fitter(cfg, dev).sep_xs
    zero = zero_rows(cfg)
    x = rn(B, H // 2, W // 2, 16).to(bf)
    wt, bias = rn(16, 4, 2, 2) / 4.0, 0.1 * rn(4)
    dS = rn(B, H, 8)
    with torch.no_grad():
        S = lm.head_rowsums_op(x, wt, bias, xs, zero)
        torch.cuda.synchronize()
        pS = lm.head_rowsums_fwd_plain(x, wt, bias, xs, zero)
        args = (x, dS, wt, bias, xs, zero)
        grads = lm.head_rowsums_bwd_kernel(*args)
        torch.cuda.synchronize()
        pgrads = lm.head_rowsums_bwd_plain(*args)
        again = lm.head_rowsums_op(x, wt, bias, xs, zero)
    label = f"head_rowsums_op{tuple(x.shape)}"
    verdict = hold(label, [("S", S, pS, TOL_F32)] + list(zip(
        ("dx", "dweight", "dbias"), grads, pgrads)), s, failures)
    if not torch.equal(S, again) or S[:, :zero].abs().max().item() != 0.0:
        failures.append(f"{label}: S does not reproduce itself bit for bit "
                        "or its masked rows are not zero")
    logits = B * (H - zero) * W * 4

    def head_op_work(bwd):
        # forward: the taps, the activation and the sums; backward: the
        # taps again, ddec, and the input and weight gradients
        flop = logits * ((2 * 16 + 5) if not bwd else (3 * 2 * 16 + 8))
        nbytes = 2 * x.numel() + 4 * S.numel() + 2 * wt.numel()
        return flop, nbytes + bwd * 2 * x.numel()
    time_and_record(
        label, s, 1, verdict,
        lambda: lm.head_rowsums_op(x, wt, bias, xs, zero),
        lambda: lm.head_rowsums_fwd_plain(x, wt, bias, xs, zero),
        lambda: lm.head_rowsums_bwd_kernel(*args),
        lambda: lm.head_rowsums_bwd_plain(*args), head_op_work)
    return summary, failures


def synthetic_batch(seed: int) -> dict:
    """A seeded batch of 8 in the dataset's compact form (host tensors)."""
    g = torch.Generator().manual_seed(seed)
    H, W = RESIZE, 2 * RESIZE
    horizon = torch.zeros(BATCH, H)
    horizon[torch.arange(BATCH), torch.randint(H // 4, H // 2, (BATCH,),
                                               generator=g)] = 1.0
    return {
        "image": torch.randint(0, 256, (BATCH, H, W, 3), generator=g,
                               dtype=torch.uint8),
        "lanes": W * torch.rand(BATCH, 4, 56, generator=g),
        "valid_points": (torch.rand(BATCH, 4, 56, generator=g) > 0.3).float(),
        "line": (torch.rand(BATCH, 4, generator=g) > 0.3).float(),
        "horizon": horizon}


TRAIN_OPS = ("nb_half_a", "nb_half_b", "downsampler_op", "lane_maps_op",
             "head_rowsums_op", "channel_sums")
# wrapper launches per step, (forward, backward); channel_sums has no
# backward kernel
PER_STEP = {
    True: {"nb_half_a": (17, 17), "nb_half_b": (17, 17),
           "downsampler_op": (3, 3), "lane_maps_op": (2, 2),
           "head_rowsums_op": (1, 1), "channel_sums": (0, 0)},
    False: {"nb_half_a": (17, 17), "nb_half_b": (17, 17),
            "downsampler_op": (0, 0), "lane_maps_op": (0, 0),
            "head_rowsums_op": (0, 0), "channel_sums": (5, 0)}}
# the eval step: no backward, the head on lane_maps_op, no fused tail
PER_EVAL = {"nb_half_a": (17, 0), "nb_half_b": (17, 0),
            "downsampler_op": (3, 0), "lane_maps_op": (3, 0),
            "head_rowsums_op": (0, 0), "channel_sums": (0, 0)}
# calls of torch.nn.functional per train step: the two heads' eight
# convolutions and the line head's pool; with fused_maps off also the
# backbone's three downsamplers, two upsamplers and output head
F_CALLS = {True: {"conv2d": 8, "max_pool2d": 1, "conv_transpose2d": 0},
           False: {"conv2d": 11, "max_pool2d": 4, "conv_transpose2d": 3}}


def train_wrappers():
    from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
    from lanedetection_end2end_tpu_torch.ops import nb_block as nb
    from lanedetection_end2end_tpu_torch.ops import packed_conv as pc
    return {"nb_half_a": nb.nb_half_a, "nb_half_b": nb.nb_half_b,
            "downsampler_op": lm.downsampler_op,
            "lane_maps_op": lm.lane_maps_op,
            "head_rowsums_op": lm.head_rowsums_op,
            "channel_sums": pc.channel_sums}


def reset_counts(wrappers):
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "bwd_launches"):
            w.bwd_launches = 0


def read_counts(wrappers):
    return {n: (w.launches, getattr(w, "bwd_launches", 0))
            for n, w in wrappers.items()}


def train_phase(dev, sd0, profile=False):
    """Phase 4. Returns {kernel: (forward, backward) launches} of the
    counted steps: of the 3 default steps, and for `channel_sums` of the
    one step with `fused_maps=False`."""
    import torch.nn.functional as F

    from lanedetection_end2end_tpu_torch.config import train_sh_config
    from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
    from lanedetection_end2end_tpu_torch.train.optim import define_optim
    from lanedetection_end2end_tpu_torch.train.steps import (
        make_eval_step, make_train_step)

    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0,
                          compute_dtype="bfloat16")
    model = LaneNet(cfg, device=dev)
    batch = synthetic_batch(SEED + 3)

    damped = {k: v * BN2_DAMP if k.endswith("bn2.weight") else v
              for k, v in sd0.items()}

    def fresh_step(sd=sd0, fused_maps=True):
        model.load_state_dict(sd)
        opt = define_optim(model.parameters(), cfg.optimizer,
                           cfg.learning_rate, cfg.weight_decay,
                           cfg.clip_grad_norm)
        return make_train_step(model, cfg, opt, fused_maps=fused_maps)

    def one_step(step, generator, batch=batch):
        """-> (loss, {name: gradient}, ms of the step)."""
        t0 = time.perf_counter()
        metrics = step(batch, generator)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        grads = {k: p.grad.float().flatten().clone()
                 for k, p in model.named_parameters() if p.grad is not None}
        return metrics["loss"].item(), grads, ms

    def whole(grads):
        return torch.cat(list(grads.values()))

    def cosine(a, b):
        a, b = a.double(), b.double()
        return (torch.dot(a, b) / (a.norm() * b.norm())).item()

    # 4a. one step with dropout off, on the kernels and on their plain
    # versions. The seeded weights as drawn: the loss, and the gradients of
    # the heads' last layers, which see the encoder's features directly.
    loss_k, g_k, _ = one_step(fresh_step(), None)
    with plain_versions():
        loss_p, g_p, _ = one_step(fresh_step(), None)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    near = {k: (cosine(g_k[k], g_p[k]), (g_k[k].norm() / g_p[k].norm()).item())
            for k in g_p if k.startswith(NEAR_LOSS + SHOWN)}
    ratio = (whole(g_k).norm() / whole(g_p).norm()).item()
    print(f"train step, kernels vs plain versions, seeded weights: loss "
          f"{loss_k:.6g} vs {loss_p:.6g} (rel {rel:.3e}); gradient (cosine, "
          f"norm ratio) of the leaves next to the loss: "
          + ", ".join(f"{k} ({c:.6f}, {r:.5f})" for k, (c, r) in near.items())
          + f"; whole gradient cosine {cosine(whole(g_k), whole(g_p)):.4f}, "
          f"norm ratio {ratio:.4f} (the decoder's output convolution and "
          f"the whole gradient are not held, see the docstring)")
    held = [v for k, v in near.items() if k.startswith(NEAR_LOSS)]
    if (len(held) != 4 or rel > 1e-2
            or not torch.isfinite(whole(g_k)).all().item()
            or any(c <= COS_HEADS or not 0.9 < r < 1.1 for c, r in held)):
        fail("the train step on the kernels disagrees with the step on "
             "their plain versions (seeded weights)")

    # The residual branches damped: the whole gradient, against the plain
    # step's own cosine under a one-pixel change of the input.
    nudged = dict(batch, image=batch["image"].clone())
    nudged["image"][0, RESIZE // 2, RESIZE, 0] ^= 1
    loss_k, g_k, _ = one_step(fresh_step(damped), None)
    with plain_versions():
        loss_p, g_p, _ = one_step(fresh_step(damped), None)
        _, g_n, _ = one_step(fresh_step(damped), None, nudged)
    g_k, g_p, g_n = whole(g_k), whole(g_p), whole(g_n)
    cos, yardstick = cosine(g_k, g_p), cosine(g_p, g_n)
    ratio = (g_k.norm() / g_p.norm()).item()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"train step, kernels vs plain versions, bn2 scales x {BN2_DAMP}: "
          f"loss {loss_k:.6g} vs {loss_p:.6g} (rel {rel:.3e}), gradient "
          f"cosine {cos:.6f} (plain step vs itself with one pixel nudged: "
          f"{yardstick:.6f}), norm ratio {ratio:.5f} over {g_k.numel()} "
          f"values")
    if not (rel <= 1e-2 and cos > 0.9 and cos >= yardstick - 0.02
            and 0.98 < ratio < 1.02 and torch.isfinite(g_k).all().item()):
        fail("the train step on the kernels disagrees with the step on "
             "their plain versions (damped weights)")

    # the eval step on the same kernels: running statistics, no gradient
    wrappers = train_wrappers()
    model.load_state_dict(sd0)
    reset_counts(wrappers)
    metrics, outputs = make_eval_step(model, cfg)(batch)
    torch.cuda.synchronize()
    if read_counts(wrappers) != PER_EVAL:
        fail(f"eval step launches {read_counts(wrappers)}, expected "
             f"{PER_EVAL}")
    shapes = {k: tuple(v.shape) for k, v in outputs.items()}
    if (shapes != {"beta": (BATCH, 4, cfg.order + 1),
                   "x_cal": (BATCH, 4, 56), "line_pred": (BATCH, 4),
                   "horizon_pred": (BATCH, RESIZE)}
            or not all(torch.isfinite(v.float()).all().item()
                       for v in (*outputs.values(), *metrics.values()))):
        fail(f"eval step outputs {shapes}")
    print(f"eval step: loss {metrics['loss'].item():.6g}, outputs finite, "
          f"launches (forward, backward) {PER_EVAL}")
    with torch.no_grad():
        out = model.apply_packed(batch["image"].to(dev).float() / 255.0,
                                 train=True, dtype=torch.bfloat16)
    if out.seg_logits is not None or out.weightmaps is not None:
        fail("the default train-mode forward formed the logits plane")
    model.load_state_dict(sd0)

    def counted_steps(n_steps, fused_maps, gen):
        """n_steps from the seeded weights, dropout on, every launch and
        every call of PyTorch's convolutions and pool counted and held to
        the path's numbers -> (step, counts, losses, ms per step)."""
        step = fresh_step(fused_maps=fused_maps)
        reset_counts(wrappers)
        losses, step_ms = [], []
        with count_calls(F, tuple(F_CALLS[fused_maps])) as f_calls:
            for _ in range(n_steps):
                loss, grads, ms = one_step(step, gen)
                step_ms.append(ms)
                losses.append(loss)
                if not (loss == loss and abs(loss) != float("inf")
                        and torch.isfinite(whole(grads)).all().item()):
                    fail(f"non-finite loss or gradient in a train step: "
                         f"{loss}")
        counts = read_counts(wrappers)
        print(f"train launches over {n_steps} step(s), fused_maps="
              f"{fused_maps}: (forward, backward) {counts}; calls of "
              f"torch.nn.functional {f_calls}")
        expected = {n: (n_steps * f, n_steps * b)
                    for n, (f, b) in PER_STEP[fused_maps].items()}
        if counts != expected:
            fail(f"launches {counts}, expected {expected}")
        if f_calls != {n: n_steps * c
                       for n, c in F_CALLS[fused_maps].items()}:
            fail(f"calls of torch.nn.functional {f_calls}, expected "
                 f"{F_CALLS[fused_maps]} per step")
        if step.state.step != n_steps:
            fail(f"state counts {step.state.step} steps")
        return step, counts, losses, step_ms

    # 4b. the main path: 3 steps in the default configuration
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    step, counts, losses, step_ms = counted_steps(TRAIN_STEPS, True, gen)
    moved = sum(int((p.detach() != sd0[k].to(dev)).any().item())
                for k, p in model.named_parameters())
    n_params = sum(1 for _ in model.parameters())
    if moved < n_params - 2:  # the encoder's 1x1 predict head has no gradient
        fail(f"only {moved} of {n_params} parameter tensors moved")
    ms = statistics.median(step_ms)
    print(f"train: losses {', '.join(f'{v:.6g}' for v in losses)}; "
          f"{moved} of {n_params} parameter tensors moved")
    print(f"train: {ms:.3f} ms per step of {BATCH} (median of {TRAIN_STEPS}: "
          f"{', '.join(f'{t:.3f}' for t in step_ms)}), "
          f"{1e3 * BATCH / ms:.1f} images/s, bf16, adam, dropout on")
    if profile:
        profile_steps(lambda: step(batch, gen), ms, "fused_maps=True")

    # 4c. one step with fused_maps=False: the cuDNN stride-2 blocks with
    # channel_sums, and the elementwise tail over the logits
    step0, counts0, losses0, step0_ms = counted_steps(1, False, gen)
    print(f"train, fused_maps=False: loss {losses0[0]:.6g}, "
          f"{step0_ms[0]:.3f} ms for the one step (its first: no warm-up)")
    if profile:
        step0(batch, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step0(batch, gen)
        torch.cuda.synchronize()
        profile_steps(lambda: step0(batch, gen),
                      1e3 * (time.perf_counter() - t0), "fused_maps=False")
    counts["channel_sums"] = counts0["channel_sums"]
    return counts


OWN_KERNELS = (  # device functions of csrc/, as the profiler names them
    "conv3tap_kernel", "wgrad3tap_kernel", "dyv_kernel",
    "channel_sums_kernel", "ds_fwd_kernel", "ds_dx_kernel", "lm_fwd_kernel",
    "l2s_kernel", "wgrad_s2_kernel", "dyv_fold_kernel", "hr_ddec_kernel",
    "head_rowsums_kernel")


def profile_steps(run_step, step_ms: float, label: str,
                  steps: int = 2) -> None:
    """`--profile`: trace `steps` more train steps with torch.profiler and
    print, after `label`, the card's busy time per step, its idle share of
    the untraced step time `step_ms`, the number of device kernels per
    step, and the kernels that took most of the card's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
    # device kernels only: not the ops that launch them, nor the ranges
    # (such as the optimizer's step) that only span them
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")
            and e.self_device_time_total > 0]
    if not rows:
        print(f"profile {label}: the trace shows no device time")
        return
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    launches = sum(e.count for e in rows) / steps
    print(f"profile {label}: card busy {busy:.3f} ms of the {step_ms:.3f} "
          f"ms step (idle share {1 - busy / step_ms:.3f}), {launches:.0f} "
          f"device kernels per step")
    groups = dict.fromkeys(OWN_KERNELS, 0.0)
    for e in rows:
        for name in groups:
            if name in e.key:
                groups[name] += e.self_device_time_total / 1e3 / steps
    own = sum(groups.values())
    print(f"profile {label}: the hand-written kernels {own:.3f} ms per "
          f"step (" + ", ".join(f"{n} {v:.3f}" for n, v in groups.items()
                                if v > 0)
          + f"), everything else {busy - own:.3f} ms")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:16]:
        print(f"profile {label}:   "
              f"{e.self_device_time_total / 1e3 / steps:8.3f} ms "
              f"x{e.count / steps:6.0f}  {e.key[:100]}")


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
               for n in SERVING}
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
    # 2b. training kernels against their plain versions ------------------
    train_summary, failures = check_training_kernels(dev, g)
    lanemap_summary, lanemap_failures = check_lanemap_kernels(dev, g)
    train_summary.update(lanemap_summary)
    failures += lanemap_failures
    failures += check_blocks_through_autograd(dev, g, model.net)
    if failures:
        fail("training kernel disagrees with its plain version: "
             + "; ".join(failures))

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

    # 4. train steps ------------------------------------------------------
    train_launches = train_phase(
        dev, {k: v.detach().clone() for k, v in model.state_dict().items()},
        profile="--profile" in sys.argv[1:])

    # 5. kernels line and result ----------------------------------------
    kernels = []
    for n, s in {**summary, **train_summary}.items():
        fwd_source, bwd_source = SOURCES.get(n, (f"{n}.cu", None))
        entry = {
            "name": n, "route": "cuda", "source": CSRC + fwd_source,
            "replaces": REPLACES[n],
            "launches": (launches[n] if n in SERVING
                         else train_launches[n][0]),
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": ("operations" if 2 * s.get("ops_ms", 0.0)
                         > s["bound_ms"] else "bytes"),
            "library_ms": s.get("library_ms")}
        if bwd_source is not None:
            entry.update(
                bwd_source=CSRC + bwd_source,
                bwd_launches=train_launches[n][1], bwd_ms=s["bwd_ms"],
                plain_bwd_ms=s["plain_bwd_ms"],
                bwd_bound_ms=s["bwd_bound_ms"],
                max_rel_err_reduce=s["max_rel_err_reduce"])
        if "library_of" in s:
            entry.update(library_of=s["library_of"],
                         ms_at_library_shape=s["ms_at_library_shape"])
        kernels.append(entry)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
