#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

`--profile` also traces two more calls of each engine (full, blocks, blocks
with the rolled homography) and two more train steps of each of the four
training configurations ({`fused_blocks`} x {`fused_maps`}) in bf16 and in
float32 with torch.profiler and prints the card's busy time per call or
step and its largest kernels. Needs one CUDA card, nvcc and the repository
checkout; exits non-zero on any failed check and prints no result without
a card. In order:

1. build the fifteen kernel libraries from
   `lanedetection_end2end_tpu_torch/csrc/` (one nvcc per source, all at
   once) and print the card's name and power limit;
2. hold each serving kernel against its plain PyTorch version on CUDA
   tensors at every shape the 256x512 serving path gives it (batch 8),
   plus one edge shape with dilation >= plane height, and time both with
   CUDA events; then K4 once at each of its six activation codes (square,
   sigmoid, relu, softplus, abs, none);
2b. the same for the training kernels, in bf16 and then in float32:
   forward and backward of `nb_half_a` and `nb_half_b` at every (C, d,
   plane) of the 256x512 train step at batch 8 plus the d >= H edge (in
   float32 each beside its single-TF32 control, see below), and
   the stride-2 ops at their seven shapes: `downsampler_op` x3 (inputs
   with planted pooling ties, the input gradient required at all three),
   `lane_maps_op` x3 (the two upsamplers with moments, the head with f32
   output and none) and `head_rowsums_op`, in float32 each K8 / K9
   product result (y, dx, dweight) beside its single-TF32 control, and
   every K8 / K9 shape timed beside cuDNN's products (`F.conv2d`,
   `F.conv_transpose2d`, `conv2d_weight`, TF32 off); then one whole
   NB1D block per (C, d) and every downsampler and upsampler block
   forward and backward through autograd (bf16), on the kernels and on
   their plain versions;
2d. K11 and `channel_sums` in bf16 and in float32: `packed_conv_act`
   forward and backward (dx, dk, db) and `packed_conv` forward, dx and dW
   at every (plane, d, axis) of the unfused 256x512 train step at batch 8
   (64 channels d = 1, 128 channels d = 1, 2, 4, 8, 16, 16 channels
   d = 1, each as a 3x1 convolution with relu and a 1x3 one without; in
   float32 each weight gradient beside its single-TF32 control), and
   `channel_sums` at its five stride-2 and three NB1D planes, against the
   plain versions, timed beside them and beside one cuDNN call
   (`F.conv2d` + relu forward, `aten.convolution_backward` with the relu
   mask, on channels_last operands of the same dtype, TF32 off);
2c. the kernels of the blocks-mode engine: `nb1d_chain` at its four
   256x512 chains and the resize-64 d = 16 edge against its plain version
   and, bit for bit, against K1 launched block by block (its input left
   untouched); `wls_moments` (K12) on the masked maps of one blocks-engine
   call with a general homography (the config's BP trapezoid after a 2
   degree camera roll) and at the JAX package's three test shapes, against
   its plain version, bit for bit against a second launch, and its
   gradient through autograd against autograd of the plain version;
3. serve 3 batches of 8 random 256x512 images through
   `FusedLaneNetEngine` (train_sh config, seeded random weights with
   non-trivial BatchNorm statistics), check the kernel launch counts of
   those calls (per call 1 `encoder_fused` and 1 `decoder_fused`, the
   whole encoder and the whole decoder as one cooperative launch each, and
   0 of K1-K4, `nb1d_chain`, `wls_moments`) and hold beta / line / horizon
   against the plain float32 `LaneNet` on the card (TF32 off);
3b. the same 3 batches through the same engine's blocks path, with the
   launch counts set to 0 just before: per call 4 `nb1d_chain`, 0 of K1-K4
   and 0 `wls_moments` with the config's homography (the path driven
   through `engine._run(..., blocks=True)`, JAX's `mode="blocks"`); then
   with the rolled homography as the engine's fitter, which sends the
   public call down the blocks path, 1 `wls_moments` per call, beta held
   against the f32 `LaneNet` whose fit takes the rolled homography's
   moments from K12's plain version; ms per batch beside the full
   engine's;
3c. the block path (`encoder_blocks` -> `decoder_blocks`: 17 K1, 3 K2, 2
   K3, 1 K4 per call) on the same 3 batches with the launch counts set to
   0 just before; `encoder_fused` and `decoder_fused` bit for bit against
   it on every batch and at the resize-64 edge (the 8x16 NB1D-128 plane
   with d = 16 >= H, W), against their plain versions, timed beside the
   block sequence, the plain versions and the bound; one occupancy line
   per fused kernel (registers and local bytes a thread, blocks and warps
   resident per SM, grid, shared memory, and the grid barriers the kernel
   counts in a call: no local memory, at least 16 warps per SM, 28 and 10
   barriers); the block sequence timed stage by stage (K1 at each (C, d),
   K2 at its three shapes, K3 at its two, K4), with cuDNN's products alone
   at the five stride-2 shapes (`library` lines); then the row-12
   harness (`lanedetection_end2end_tpu_torch/tools/prof_block_stack.py`,
   the block applied 8 times per `nb1d_chain` launch) at batch 32 with 1,
   2 and 4 images per launch, its counted pass of 32 + 16 + 8 launches,
   the stacked outputs bit for bit the single-image ones, and its
   block-img/s per stack;
3d. the wide phase: the engine of `train_sh_config(resize=512)` on 2
   batches of 2 seeded 512x1024 images, whose NB1D rows are wider than
   a row tile (the tile then owns a segment of a row and computes its
   halo columns), on the full path and on the blocks path, each with its
   launch counts set to 0 just before (1 + 1 fused kernels, or 4 chains,
   per call), held to the plain float32 `LaneNet` at the JAX bars; the
   fused kernels bit for bit their block sequence and against their
   plain versions (TOL_BLOCK, TOL_S), and their occupancy line for the
   segments' build, held as in 3c; K1 at each channel count and one
   `nb1d_chain` against their plain versions on rows wider than a tile,
   partial last segments included (W = MT + 16), the chain also bit for
   bit K1 block by block;
4. take e2e train steps through `make_train_step` (same config with
   compute_dtype bfloat16, then again with float32, the config's default;
   adam, seeded random weights, a seeded synthetic batch of 8): first one
   step with dropout off on the kernels and the same step on the plain
   versions on the card (see below), one eval step with its launches
   counted (the head on `lane_maps_op`, no fused tail), then, from the
   seeded weights and with the launch counts set to 0, 3 steps with
   dropout on in the default configuration (`fused_maps=True`): per step
   exactly 17 launches of each of nb_half_a / nb_half_b forward and
   backward, 3 + 3 of downsampler_op, 2 + 2 of lane_maps_op, 1 + 1 of
   head_rowsums_op and 0 of channel_sums, no call of `F.conv_transpose2d`
   and only the heads' `F.conv2d` / `F.max_pool2d`, no logits plane,
   finite loss and gradients, parameters moved; then, counted anew, one
   step with `fused_maps=False` (17 / 17 / 17 / 17 and 5 of
   channel_sums), which keeps that path driven;
4d. the unfused path (`fused_blocks=False`, JAX `PACKED_FUSED_BLOCKS=0`),
   first in bf16, then in float32: one step with dropout off on the
   kernels against one on the plain versions (bf16 as in 4a; float32 see
   below), one eval step (68 launches of packed_conv_act and nothing else
   counted), then 3 counted steps with dropout on: per step exactly 68 + 68
   of packed_conv_act, 39 of channel_sums (34 NB1D BatchNorms and 5
   stride-2 ones) and 0 of every other kernel; then, counted anew, one
   step with `fused_maps=True`, the fourth cell: 68 + 68 of
   packed_conv_act, 34 of channel_sums, 3 + 3 / 2 + 2 / 1 + 1 of K8-K10;
4e. the race check: this script again with `--race-child` (one
   `encoder_fused`, one `decoder_fused` and one `nb1d_chain` call at
   resize 64, and one `nb1d_chain` call on rows wider than its tile) in a
   child process under `compute-sanitizer --tool racecheck`, then
   `--tool synccheck`; a reported hazard or error, a non-zero exit or a
   timeout fails the run; where the tool is missing or refuses the card
   ("Device not supported"), the kernels line says so and no race check
   is claimed;
5. print the card line as nvidia-smi gives it, the kernels line (with
   the wide phase's and the race check's results beside the kernels),
   and `{"ok": true, "device": {...}}` last.

In the kernels line, `launches` counts the wrapper calls of the 3 engine
calls (`encoder_fused`, `decoder_fused`; `nb1d_chain` and `wls_moments`:
the 3 + 3 calls of phase 3b), of the 3 calls of the block path (K1-K4,
phase 3c), of the harness's counted pass (`row12`, which names
`nb1d_chain.cu` as its source) or of the 3 default bf16 train steps (training
kernels, with `bwd_launches` beside it; for K11 and `channel_sums` of the
3 bf16 steps of phase 4d), and
`ms`, `plain_ms` and `bound_ms` are per
engine call or per train step (batch 8): the sum over the path's shapes of
the median time (or bound) times the launches per call (for K11 and
`channel_sums` per unfused step; `packed_conv`, which no path runs, is
weighted as if the step ran it at each of its 68 convolutions).
`encoder_fused` and `decoder_fused` carry their time per call beside
`block_sequence_ms`, that of the 23 wrapper calls of K1-K4 computing the
same outputs, and their bound counts only the bytes that must cross HBM
(the image, the constants and enc; enc, the constants and S); `row12`'s
`ms` is one pass of 32 single-image launches, with `block_img_per_s` per
stack. Every
training kernel (K6-K11, `channel_sums`) carries its float32 numbers in a
`float32` object beside the bf16 ones, with the launches of the 3 float32
default steps (K6-K10) or of the 3 float32 unfused steps (K11,
`channel_sums`). The training
kernels carry the same numbers for their backward as `bwd_ms`,
`plain_bwd_ms`, `bwd_bound_ms`. `bound_ms` is the larger of the bytes
moved (each input read once, each output written once: 3 planes for a
half block's forward, 5 for its backward; x and y for a stride-2 op's
forward, x, y, dy and dx for its backward) over 3.35 TB/s and the FLOP of
the taps that land on the plane over 989 TFLOP/s (bf16), over 495 / 3 =
165 TFLOP/s for the float32 tiles of K6-K9 and K11, which take three TF32
tensor-core products per f32 product (3xTF32; their FFMA bound at 67
TFLOP/s beside it as `ffma_bound_ms` / `bwd_ffma_bound_ms`), or over 67
TFLOP/s (float32 K10, FFMA); `library_ms` is
null where no single PyTorch call computes the fused function, for
wls_moments the time of `torch.matmul` (TF32 off) of the squared weights,
laid out as (B*C, N), with the basis, at the engine's shape, for
channel_sums the time of `torch.var_mean(x.float(), dim=(0, 1, 2))`, which
gives the same statistics, for the serving downsampler and upsampler
(K2, K3) cuDNN's bf16 product alone at their shapes per engine call
(`F.conv2d` 3x3/s2/p1, `F.conv_transpose2d`, channels_last; no pool,
BatchNorm or relu), for downsampler_op and lane_maps_op cuDNN's
products alone on the same operands (bf16, or float32 with TF32 off) at
the train step's shapes, which no single call computes with the bias, the
pool and the moments (`library_of` says which calls; forward: `F.conv2d`
3x3/s2/p1, `F.conv_transpose2d`; `bwd_library_ms`: the transposed
convolution or the convolution for dx plus `conv2d_weight`; K9's 2x2 head,
on the eval step only, apart as `head_library_ms` beside the kernel's
`head_ms`), for K11 the cuDNN calls of phase 2d (`bwd_library_ms` for the
backward). None is used in the port.

Tolerances: a kernel and its plain version do the same bf16-operand,
f32-accumulate arithmetic in another summation order, so bf16 outputs may
differ by an output rounding step (2^-8 relative) and the nb1d chain of
four roundings by a few: max|diff| / max|plain| < 1e-2. A whole chain
(`nb1d_chain`) carries those steps through up to 8 blocks and their
residuals: measured on an H100, 9.3e-3 after the five 64-channel blocks and
1.2e-2 after the eight 128-channel ones, for the chain and for K1 block by
block alike, so a chain is held at 2e-2 of max|plain|, the bar the JAX
package holds its own chain to (tests/test_pallas_wls.py:180), and must
moreover equal K1 block by block bit for bit: both run the same device
code. Likewise the whole encoder and the whole decoder run K1-K4's device
code (the decoder's head K4's row body, in K4's order of operations) and
must equal the block sequence bit for bit; against their plain versions
they carry the chains' rounding steps through 16 and 7 stages: enc is
held at TOL_BLOCK of max|plain| (measured on an H100: up to 1.63e-2,
the NB1D-128 chain alone 1.2e-2), and the decoder's f32 row sums S,
sums of the fourth power of logits computed from those bf16 planes, at
TOL_S = 5e-3 (measured up to 2.04e-3). A control, the plain decoder with every
logit 1 + 2^-8 times too large (S off by about 4 x 2^-8 = 1.6e-2, under
TOL_BLOCK), must read above TOL_S in the same run. K12's
moments are f32 sums in another order than the plain version's float64
ones: max|diff| / max|plain|
<= 1e-4, the bar the JAX package holds its own kernel to against a float64
oracle, and two launches agree bit for bit (fixed summation order, no
atomics). The f32 row sums
of head_rowsums differ only by f32 summation order: < 1e-4. The engine
against the f32 LaneNet: the JAX package's own bars (beta max relative
error < 3e-2, line/horizon rtol = atol = 1e-2). The training kernels'
f32 reductions (moments, dk, db, dmul, dadd) sum bf16-exact products in
another order, with atomics, over operands of which a few may differ from
the plain version's by one bf16 step: max|diff| / max|plain| < 2e-3. The
stride-2 ops have no relu inside and their pool routing is a function of
the input alone, so the same bars hold for them without exception, planted
ties included; the row sums S of head_rowsums_op at 1e-4, and S, dx,
dweight and dbias bit for bit against a second launch (K10 sums its
gradients in a fixed order, no atomics). In float32 the planes of K6-K10
(y, dx) are held at TOL_F32 = 1e-4 of max|plain| and their f32 atomic
sums at TOL_REDUCE, except the weight gradients of K6-K9 and K11 and
K10's fixed-order dweight and dbias, held at TOL_F32 too. K10, the first
downsampler and K9's 2x2 head sum exact f32 products (FFMA) in another
order than the plain versions. K6-K9 and K11 multiply on the
tensor cores in 3xTF32: each f32
operand split into a TF32 high part and a TF32 remainder, three TF32
products per f32 product, which loses about 2^-22 of each product, below
f32 rounding (ops/tf32x3.py; about 1e-7 of max|plain| against a float64
convolution or weight gradient in the CPU tests). One TF32 product alone
keeps 10 mantissa bits and reads about 3e-4 there, so beside each float32
K6 / K7 reading (y, dx, dkh, dkw), each float32 K8 / K9 reading (y, dx,
dweight) and each float32 K11 weight gradient a
control, the plain version with the operands of its convolutions or of
its weight gradients rounded to TF32, must read above TOL_F32 in the same
run: the bar tells the split from a single product, in the convolutions
and in the weight gradients alike. K4 at every activation code: its f32
row sums at TOL_F32. K11's backward is held on the plain forward's
output, so the kernel and the plain version take the relu mask from the
same values: bf16 planes (y, dx) at TOL_BF16, f32 planes (packed_conv's y
in both dtypes, every float32 y and dx) and the float32 weight gradients
at TOL_F32 = 1e-4 of max|plain| (the 3xTF32 products keep f32 accuracy;
one TF32 product would miss that bar), the bias gradients and the bf16
weight gradients, summed with f32 atomics over up to 262,144 pixels, at
TOL_REDUCE; `channel_sums` at TOL_REDUCE in bf16 and TOL_F32 in float32.

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

The float32 steps (the default one and the unfused one) amplify
rounding the same way, from f32's
smaller steps: on the seeded weights as drawn its loss agrees with the
plain step's to 1e-6, but f32 summation order alone moves the whole
gradient off by 1e-3 in cosine (measured on an H100: the kernel step
against the plain step 0.99949 and 0.99875 in two runs, against its own
rerun, whose f32 atomics add in another order, 0.99818). So on those
weights the loss is held within 2e-3 relative, the whole-gradient cosine
at 0.995 and the norm ratio within 1e-2 of 1; with the residual branches
damped as above, where the same rounding can no longer grow, the cosine is
held at 0.99999 and the norm ratio within 1e-4 of 1.
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
FP32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
# float32 products as three TF32 tensor-core products (3xTF32, the float32
# tiles of csrc/conv3tap_f32.cuh): the H100's 495 TFLOP/s dense TF32 over 3
TF32X3_FLOP_PER_S = 495e12 / 3
ROLL_DEGREES = 2.0  # camera roll of the general (non-separable) homography
TOL_BF16, TOL_F32, TOL_REDUCE, TOL_BLOCK = 1e-2, 1e-4, 2e-3, 2e-2
TOL_S = 5e-3  # the fused decoder's row sums S against its plain version
EDGE_BATCHES = 4  # batches of 2 at the resize-64 edge in phase 3c
TRAIN_STEPS = 3
DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
# the float32 unfused step on the kernels against the step on their plain
# versions: loss relative difference, and (least whole-gradient cosine,
# largest |norm ratio - 1|) on the seeded weights as drawn and on damped
# ones (see the docstring)
F32_LOSS, F32_AS_DRAWN, F32_DAMPED = 2e-3, (0.995, 1e-2), (0.99999, 1e-4)
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
    "nb1d_chain": "lanedetection_end2end_tpu/ops/pallas_nb1d.py:320",
    "wls_moments": "lanedetection_end2end_tpu/ops/pallas_wls.py:36",
    "packed_conv_act":
        "lanedetection_end2end_tpu/ops/pallas_packed_conv.py:245",
    "packed_conv": "lanedetection_end2end_tpu/ops/pallas_packed_conv.py:112",
    "encoder_fused": "lanedetection_end2end_tpu/models/fused_graph.py:178",
    "decoder_fused": "lanedetection_end2end_tpu/models/fused_graph.py:178",
    "row12": "tools/prof_block_stack.py:67",
}
# kernel -> (forward source, backward source) where they are not `name`.cu
SOURCES = {
    "nb_half_a": ("nb_half_fwd.cu", "nb_half_bwd.cu"),
    "nb_half_b": ("nb_half_fwd.cu", "nb_half_bwd.cu"),
    "downsampler_op": ("downsampler_op.cu", "downsampler_op.cu"),
    "lane_maps_op": ("lane_maps_op.cu", "lane_maps_op.cu"),
    "head_rowsums_op": ("head_rowsums_op.cu", "head_rowsums_op.cu"),
    "packed_conv_act": ("packed_conv.cu", "packed_conv.cu"),
    "packed_conv": ("packed_conv.cu", "packed_conv.cu"),
    "row12": ("nb1d_chain.cu", None),
}
# what a kernel's library_ms measures where it is not one call of the
# same function (K8 / K9: cuDNN's products only), and K9's head shape
LIBRARY_NOTES = ("library_of", "head_library_ms", "head_ms")
SERVING = ("nb1d", "downsampler", "upsampler", "head_rowsums")
FUSED = ("encoder_fused", "decoder_fused")  # the full engine's kernels
BLOCKS = ("nb1d_chain", "wls_moments")  # the blocks-mode engine's kernels
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


def bound_ms(flop, nbytes, flop_per_s=BF16_FLOP_PER_S):
    t_ops, t_bytes = flop / flop_per_s, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def half_work(shape, d, backward, es=2):
    """One half block on planes of `es` bytes per value: two 3-tap
    convolutions forward; their two input gradients and two weight
    gradients backward (the taps read, their f32 gradients written)."""
    B, H, W, C = shape
    valid = lambda n, k: n + 2 * max(0, n - k)
    taps = valid(H, d) * W + valid(W, d) * H
    flop = 2 * C * C * B * taps * (2 if backward else 1)
    plane = es * B * H * W * C
    small = 2 * 3 * C * C * (es + (4 if backward else 0)) + 4 * 6 * C
    return flop, (5 if backward else 3) * plane + small


def sums_work(shape, es=2):
    n = 1
    for v in shape:
        n *= v
    return 3 * n, es * n + 8 * shape[-1]


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
             "packed_conv_act": pc.packed_conv_act_fwd_plain,
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
    plain result[, tol_f32]). bf16 planes at TOL_BF16 of max|plain|, f32
    results at TOL_REDUCE (`tol_f32` overrides it). Records the worst
    errors in `s`,
    appends to `failures`, returns the verdict for the check line."""
    bad = []
    for name, got, want, *tol_f32 in pairs:
        err, rel = rel_err(got, want)
        reduce = got.dtype == torch.float32
        tol = (tol_f32[0] if tol_f32 else TOL_REDUCE) if reduce else TOL_BF16
        if reduce:
            s["max_rel_err_reduce"] = max(s["max_rel_err_reduce"], rel)
            s["max_abs_err_reduce"] = max(s["max_abs_err_reduce"], err)
        if not reduce or tol_f32:  # a plane, or an f32 result held at 1e-4
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


def time_and_record(label, s, per_step, verdict, fwd, pfwd, bwd, pbwd, work,
                    flop_per_s=BF16_FLOP_PER_S):
    """Time a training kernel's forward and backward and their plain
    versions (medians), compute both bounds from `work(backward)` ->
    (flop, bytes) at `flop_per_s`, print the check line and add `per_step`
    times each number to the summary `s`. At TF32X3_FLOP_PER_S (the
    float32 tiles on the tensor cores) the FFMA bounds, at
    FP32_FLOP_PER_S, are printed and summed beside them (`ffma_bound_ms`,
    `bwd_ffma_bound_ms`). Returns the forward's and the backward's ms."""
    with torch.no_grad():
        f_ms, pf_ms = median_ms(fwd), median_ms(pfwd)
        pb_ms, b_ms = median_ms(pbwd), median_ms(bwd)
    fb, f_by = bound_ms(*work(False), flop_per_s)
    bb, b_by = bound_ms(*work(True), flop_per_s)
    ffma = ""
    if flop_per_s == TF32X3_FLOP_PER_S:
        ffb, ffbb = (bound_ms(*work(bwd_), FP32_FLOP_PER_S)[0]
                     for bwd_ in (False, True))
        s["ffma_bound_ms"] = s.get("ffma_bound_ms", 0.0) + per_step * ffb
        s["bwd_ffma_bound_ms"] = (s.get("bwd_ffma_bound_ms", 0.0)
                                  + per_step * ffbb)
        ffma = f"; FFMA bounds {ffb:.4f} / {ffbb:.4f}"
    print(f"check {label}: {verdict}; forward {f_ms:.4f} ms (plain "
          f"{pf_ms:.4f}, bound {fb:.4f} {f_by}), backward {b_ms:.4f} ms "
          f"(plain {pb_ms:.4f}, bound {bb:.4f} {b_by}){ffma}; x{per_step} "
          f"per train step")
    for key, v in (("ms", f_ms), ("plain_ms", pf_ms), ("bound_ms", fb),
                   ("ops_ms", fb * (f_by == "operations")),
                   ("bwd_ms", b_ms), ("plain_bwd_ms", pb_ms),
                   ("bwd_bound_ms", bb)):
        s[key] += per_step * v
    return f_ms, b_ms


def plane_tols(dt):
    """The extra `hold` argument of a plane of dtype `dt`: none in bf16
    (TOL_BF16 by its dtype), TOL_F32 in float32 (an f32 result is
    otherwise held at TOL_REDUCE, the bar of atomic sums)."""
    return (TOL_F32,) if dt == torch.float32 else ()


def tf32_control(label, rows, failures):
    """The float32 tiles' control: each product result of the kernels (y,
    dx, the weight gradients) against the plain version, printed beside
    the plain version computed from TF32-rounded operands (one TF32
    product, what the tiles would give without the 3xTF32 split); rows:
    (name, kernel result, plain result, control). Every control must read
    above TOL_F32, the bar these results are held to, or the bar could not
    tell the split from a single product."""
    with torch.no_grad():
        reads = [(n, rel_err(got, want)[1], rel_err(ctl, want)[1])
                 for n, got, want, ctl in rows]
    ok = min(c for _, _, c in reads) > TOL_F32
    print(f"control {label}: kernel "
          + ", ".join(f"{n} {k:.2e}" for n, k, _ in reads)
          + " of max|plain|; one TF32 product "
          + ", ".join(f"{n} {c:.2e}" for n, _, c in reads)
          + f" (must exceed {TOL_F32:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label}: the single-TF32 control reads "
                        + ", ".join(f"{n} {c:.2e}" for n, _, c in reads)
                        + f", not all above {TOL_F32:g}")


def check_training_kernels(dev, g, dt):
    """Phase 2b, the half blocks in dtype `dt`. Returns ({name: summary},
    failures)."""
    from lanedetection_end2end_tpu_torch.ops import nb_block as nb

    from lanedetection_end2end_tpu_torch.ops.tf32x3 import (
        conv3_tf32, wgrad3_tf32)

    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    es = torch.finfo(dt).bits // 8
    rate = BF16_FLOP_PER_S if dt == torch.bfloat16 else TF32X3_FLOP_PER_S
    pt = plane_tols(dt)
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
               for n in ("nb_half_a", "nb_half_b")}
    failures = []

    for half, shape, d, per_step in cases:
        C = shape[-1]
        wrapper = nb.nb_half_a if half == "a" else nb.nb_half_b
        s = summary[wrapper.__name__]
        x = rn(*shape).to(dt)
        kh, kw = rn(3, C, C) / (3 * C) ** 0.5, rn(3, C, C) / (3 * C) ** 0.5
        bh, bw = 0.1 * rn(C), 0.1 * rn(C)
        mul = add = None
        if half == "b":
            mul = 0.5 + torch.rand(C, generator=g, device=dev)
            add = 0.1 * rn(C)
        dy, dmom = rn(*shape).to(dt), 1e-3 * rn(2, C)
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
        label = f"nb_half_{half} {DTYPE_NAMES[dt]} {shape} d={d}"
        # the weight gradients of the float32 tiles at TOL_F32, beside
        # their control; the other f32 sums at TOL_REDUCE
        verdict = hold(label, [("y", y, py, *pt), ("mom", mom, pmom),
                               ("dx", grads[0], pgrads[0], *pt)]
                       + [(n, a, b, *(pt if n.startswith("dk") else ()))
                          for n, a, b in zip(names[1:], grads[1:],
                                             pgrads[1:])], s, failures)
        if dt == torch.float32:
            with torch.no_grad():
                cy = nb.half_fwd_plain(x, mul, add, kh, bh, kw, bw, d,
                                       conv=conv3_tf32)[0]
                cdx = nb.half_bwd_plain(*bwd_args, conv=conv3_tf32)[0]
                cw = nb.half_bwd_plain(*bwd_args, wgrad=wgrad3_tf32)
            got, want = dict(zip(names, grads)), dict(zip(names, pgrads))
            tf32_control(label, [("y", y, py, cy), ("dx", got["dx"],
                                                    want["dx"], cdx)]
                         + [(n, got[n], want[n], cw[i])
                            for n, i in (("dkh", 3), ("dkw", 5))], failures)
        time_and_record(
            label, s, per_step, verdict, call,
            lambda: nb.half_fwd_plain(x, mul, add, kh, bh, kw, bw, d),
            lambda: nb.half_bwd_kernel(*bwd_args),
            lambda: nb.half_bwd_plain(*bwd_args),
            lambda bwd: half_work(shape, d, bwd, es), rate)

    return summary, failures


def s2_work(small_pixels, cs, cl, k, planes_bytes, backward, es=2):
    """A stride-2 op on `small_pixels` = (B, Hs, Ws): the taps of a k x k
    kernel between cs and cl channels that land on the plane (twice
    backward: the input and the weight gradient), and the bytes of its
    planes (`planes_bytes`: (forward, backward)) plus the weights (`es`
    bytes a value read, their f32 gradient written backward)."""
    B, Hs, Ws = small_pixels
    taps = ((3 * Hs - 1) * (3 * Ws - 1) if k == 3 else 4 * Hs * Ws)
    flop = 2 * cs * cl * B * taps * (2 if backward else 1)
    return flop, (planes_bytes[backward]
                  + cs * cl * k * k * (es + (4 if backward else 0)))


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


def s2_library(label, s, per_step, k_ms, lib_fwd, lib_bwd):
    """Time cuDNN's products beside a stride-2 op at one shape, in CUDA
    events, and add `per_step` times them to `library_ms` /
    `bwd_library_ms` of the summary `s`. They are the products only (no
    single call computes the bias, the pool, the moment fold or the
    moments): `lib_fwd` the op's forward convolution, `lib_bwd` its input
    and weight gradients; `k_ms` the op's (forward, backward) times."""
    with torch.no_grad():
        l_f, l_b = median_ms(lib_fwd), median_ms(lib_bwd)
    for key, v in (("library_ms", l_f), ("bwd_library_ms", l_b)):
        s[key] = s.get(key, 0.0) + per_step * v
    print(f"library {label}: cuDNN products only, forward {l_f:.4f} ms "
          f"(kernel {k_ms[0]:.4f}, {k_ms[0] / l_f:.2f}x), backward "
          f"{l_b:.4f} ms (kernel {k_ms[1]:.4f}, {k_ms[1] / l_b:.2f}x)")
    return l_f, l_b


def check_lanemap_kernels(dev, g, dt):
    """Phase 2b, the stride-2 training ops in dtype `dt`: `downsampler_op`,
    `lane_maps_op` and `head_rowsums_op`, forward and backward (the
    backward kernels and their plain version on the same stashes, with a
    non-zero moment cotangent), at every shape of the 256x512 train and
    eval steps; in float32 each product result (y, dx, dweight) beside its
    single-TF32 control, and every shape of K8 / K9 timed beside cuDNN's
    products. Returns ({name: summary}, failures)."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_weight

    from lanedetection_end2end_tpu_torch.config import train_sh_config
    from lanedetection_end2end_tpu_torch.models.lanenet import (
        make_fitter, zero_rows)
    from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
    from lanedetection_end2end_tpu_torch.ops.tf32x3 import (
        conv_s2_tf32, convt_s2_tf32, wgrad_s2_tf32)

    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    es = torch.finfo(dt).bits // 8
    f32 = dt == torch.float32
    # K8 / K9 take three TF32 products per f32 product in float32 (their
    # FFMA bound beside it); K10 runs on FFMA
    rate = BF16_FLOP_PER_S if not f32 else TF32X3_FLOP_PER_S
    pt = plane_tols(dt)
    dname = DTYPE_NAMES[dt]
    B, H, W = BATCH, RESIZE, 2 * RESIZE
    summary = {n: dict.fromkeys(TRAIN_KEYS, 0.0) for n in
               ("downsampler_op", "lane_maps_op", "head_rowsums_op")}
    failures = []

    # K8: the three downsamplers, planted ties, dx required at all three
    s = summary["downsampler_op"]
    s["library_of"] = ("cuDNN's products only at the three downsamplers: "
                       "F.conv2d 3x3/s2/p1 forward; F.conv_transpose2d + "
                       "conv2d_weight backward (TF32 off)")
    for (h, w, cin), cout in (((H, W, 3), 16), ((H // 2, W // 2, 16), 64),
                              ((H // 4, W // 4, 64), 128)):
        cc = cout - cin
        x = plant_pool_ties(torch.relu(rn(B, h, w, cin))).to(dt)
        wt, bias = rn(cc, cin, 3, 3) / (9 * cin) ** 0.5, 0.1 * rn(cc)
        dy, dmom = rn(B, h // 2, w // 2, cout).to(dt), 1e-3 * rn(2, cout)
        with torch.no_grad():
            y, mom = lm.downsampler_op(x, wt, bias)
            torch.cuda.synchronize()
            py, pmom = lm.downsampler_fwd_plain(x, wt, bias)
            args = (x, py, dy, dmom, wt)
            grads = lm.downsampler_bwd_kernel(*args)
            torch.cuda.synchronize()
            pgrads = lm.downsampler_bwd_plain(*args)
            nodx = lm.downsampler_bwd_kernel(*args, need_dx=False)
        label = f"downsampler_op {dname} {tuple(x.shape)}->{cout}"
        verdict = hold(label, [
            ("y", y, py, *pt), ("mom", mom, pmom),
            ("dx", grads[0], pgrads[0], *pt),
            ("dweight", grads[1], pgrads[1], *pt),
            ("dbias", grads[2], pgrads[2]),
            ("dweight without dx", nodx[1], pgrads[1], *pt)], s, failures)
        if nodx[0] is not None:
            failures.append(f"{label}: dx returned though not needed")
        if f32:
            with torch.no_grad():
                cy = lm.downsampler_fwd_plain(x, wt, bias,
                                              conv=conv_s2_tf32)[0]
                cdx = lm.downsampler_bwd_plain(*args, convt=convt_s2_tf32)[0]
                cdw = lm.downsampler_bwd_plain(*args, wgrad=wgrad_s2_tf32)[1]
            tf32_control(label, [("y", y, py, cy),
                                 ("dx", grads[0], pgrads[0], cdx),
                                 ("dweight", grads[1], pgrads[1], cdw)],
                         failures)
        # forward: x read, y written; backward: x, y, dy read, dx written
        planes = (es * (x.numel() + y.numel()),
                  2 * es * (x.numel() + y.numel()))
        k_ms = time_and_record(
            label, s, 1, verdict,
            lambda: lm.downsampler_op(x, wt, bias),
            lambda: lm.downsampler_fwd_plain(x, wt, bias),
            lambda: lm.downsampler_bwd_kernel(*args),
            lambda: lm.downsampler_bwd_plain(*args),
            lambda bwd: s2_work((B, h // 2, w // 2), cc, cin, 3, planes, bwd,
                                es), rate)
        xn, wl = x.permute(0, 3, 1, 2), wt.to(dt)
        dzn = dy[..., :cc].permute(0, 3, 1, 2)
        s2_library(label, s, 1, k_ms,
                   lambda: F.conv2d(xn, wl, stride=2, padding=1),
                   lambda: (F.conv_transpose2d(dzn, wl, stride=2, padding=1,
                                               output_padding=1),
                            conv2d_weight(xn, wl.shape, dzn, stride=2,
                                          padding=1)))

    # K9: the two upsamplers (moments, output in the planes' dtype) and the
    # head as the eval step runs it (f32 out, no moments)
    s = summary["lane_maps_op"]
    s["library_of"] = ("cuDNN's products only at the two upsamplers: "
                       "F.conv_transpose2d forward; F.conv2d + "
                       "conv2d_weight backward (TF32 off); the head's shape "
                       "apart as head_library_ms beside head_ms")
    for (h, w, cin), cout, k, out_dtype, want_mom, per_step in (
            ((H // 8, W // 8, 128), 64, 3, dt, True, 1),
            ((H // 4, W // 4, 64), 16, 3, dt, True, 1),
            ((H // 2, W // 2, 16), 4, 2, torch.float32, False, 0)):
        x = rn(B, h, w, cin).to(dt)
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
        label = (f"lane_maps_op {dname} {tuple(x.shape)}->{cout} k={k} "
                 f"{DTYPE_NAMES[out_dtype]} out"
                 + ("" if want_mom else " no moments"))
        pairs = [("y", y, py, *pt)] + (
            [("mom", mom, pmom)] if want_mom else [])
        verdict = hold(label, pairs + [
            ("dx", grads[0], pgrads[0], *pt),
            ("dweight", grads[1], pgrads[1], *pt),
            ("dbias", grads[2], pgrads[2])], s, failures)
        if (mom is None) != (not want_mom):
            failures.append(f"{label}: moments returned {mom is not None}")
        if f32:
            with torch.no_grad():
                cy = lm.lane_maps_fwd_plain(x, wt, bias, k, out_dtype,
                                            want_mom, convt=convt_s2_tf32)[0]
                cdx = lm.lane_maps_bwd_plain(*args, conv=conv_s2_tf32)[0]
                cdw = lm.lane_maps_bwd_plain(*args, wgrad=wgrad_s2_tf32)[1]
            tf32_control(label, [("y", y, py, cy),
                                 ("dx", grads[0], pgrads[0], cdx),
                                 ("dweight", grads[1], pgrads[1], cdw)],
                         failures)
        ybytes = y.numel() * y.element_size()
        # backward reads y only to fold the moment cotangent
        planes = (es * x.numel() + ybytes,
                  2 * es * x.numel() + ybytes * (1 + want_mom))
        k_ms = time_and_record(
            label, s, per_step, verdict, op, plain,
            lambda: lm.lane_maps_bwd_kernel(*args),
            lambda: lm.lane_maps_bwd_plain(*args),
            lambda bwd: s2_work((B, h, w), cin, cout, k, planes, bwd, es),
            rate)
        # cuDNN on the same operands (in bf16 its output is bf16; TF32 is
        # off); timed here, used nowhere in the port
        xn, wb = x.permute(0, 3, 1, 2), wt.to(dt)
        dpn = dy.to(dt).permute(0, 3, 1, 2)
        pad = 1 if k == 3 else 0
        l_f, _ = s2_library(
            label, s, per_step, k_ms,
            lambda: F.conv_transpose2d(xn, wb, stride=2, padding=pad,
                                       output_padding=pad),
            lambda: (F.conv2d(dpn, wb, stride=2, padding=pad),
                     conv2d_weight(dpn, wb.shape, xn, stride=2,
                                   padding=pad)))
        if not want_mom:
            s["head_library_ms"], s["head_ms"] = l_f, k_ms[0]

    # K10: the fused tail, with the fitter's column coordinate and mask
    s = summary["head_rowsums_op"]
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0)
    xs = make_fitter(cfg, dev).sep_xs
    zero = zero_rows(cfg)
    x = rn(B, H // 2, W // 2, 16).to(dt)
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
        grads2 = lm.head_rowsums_bwd_kernel(*args)
    label = f"head_rowsums_op {dname} {tuple(x.shape)}"
    # the weight and bias gradients are fixed-order f32 sums (no atomics):
    # in float32 at TOL_F32, in bf16 at TOL_REDUCE (dp rounded to bf16 on
    # both sides, a rounding step may flip), and bit for bit a second launch
    sums_tol = (TOL_F32,) if f32 else ()
    verdict = hold(label, [
        ("S", S, pS, TOL_F32), ("dx", grads[0], pgrads[0], *pt),
        ("dweight", grads[1], pgrads[1], *sums_tol),
        ("dbias", grads[2], pgrads[2], *sums_tol)], s, failures)
    if not torch.equal(S, again) or S[:, :zero].abs().max().item() != 0.0:
        failures.append(f"{label}: S does not reproduce itself bit for bit "
                        "or its masked rows are not zero")
    same = [n for n, a, b in zip(("dx", "dweight", "dbias"), grads, grads2)
            if not torch.equal(a, b)]
    print(f"check {label}: dx, dweight, dbias of a second backward launch "
          f"bit for bit equal: {'ok' if not same else 'FAIL ' + str(same)}")
    if same:
        failures.append(f"{label}: {', '.join(same)} do not reproduce "
                        "themselves bit for bit")
    logits = B * (H - zero) * W * 4

    def head_op_work(bwd):
        # forward: the taps, the activation and the sums over the live
        # rows; backward: the taps again, ddec, and the input and weight
        # gradients; bytes: x read (and dx written) once, S or dS once
        flop = logits * ((2 * 16 + 5) if not bwd else (3 * 2 * 16 + 8))
        nbytes = es * x.numel() + 4 * S.numel() + 4 * wt.numel()
        return flop, nbytes + bwd * es * x.numel()
    time_and_record(
        label, s, 1, verdict,
        lambda: lm.head_rowsums_op(x, wt, bias, xs, zero),
        lambda: lm.head_rowsums_fwd_plain(x, wt, bias, xs, zero),
        lambda: lm.head_rowsums_bwd_kernel(*args),
        lambda: lm.head_rowsums_bwd_plain(*args), head_op_work,
        BF16_FLOP_PER_S if not f32 else FP32_FLOP_PER_S)
    return summary, failures


# ----------------------------------------------------------------------
# Phase 2d: K11 and channel_sums in bf16 and float32
# ----------------------------------------------------------------------

K11_KEYS = TRAIN_KEYS + ("library_ms", "bwd_library_ms")


def k11_cases():
    """(plane, d, axis, launches per unfused train step): every
    convolution of the 17 NB1D blocks at 256x512, batch 8; relu on the
    3x1 ('h') convolutions."""
    B, H, W = BATCH, RESIZE, 2 * RESIZE
    p64, p128, p16 = ((B, H // 4, W // 4, 64), (B, H // 8, W // 8, 128),
                      (B, H // 2, W // 2, 16))
    cases = [(p64, 1, a, 14) for a in "hw"] + [(p128, 1, a, 8) for a in "hw"]
    cases += [(p128, d, a, 2) for d in (2, 4, 8, 16) for a in "hw"]
    return cases + [(p16, 1, a, 4) for a in "hw"]


def k11_work(shape, d, axis, es, act, backward):
    """FLOP of the taps that land on the plane (twice backward: dx and dk)
    and bytes: forward x read and y written (y f32 without act:
    packed_conv); backward x, dy, y read and dx written with act, x and an
    f32 dy read and dx written without; plus the taps (and their f32
    gradients) and the bias."""
    B, H, W, C = shape
    valid = lambda n, k: n + 2 * max(0, n - k)
    taps = valid(H, d) * W if axis == "h" else valid(W, d) * H
    flop = 2 * C * C * B * taps * (2 if backward else 1)
    n = B * H * W * C
    if not backward:
        planes = n * es + n * (es if act else 4)
    else:
        planes = n * es * (4 if act else 2) + (0 if act else 4 * n)
    return flop, planes + 3 * C * C * (es + 4 * backward) + 4 * C


def library_conv(x, k, b, axis, d, act):
    """One cuDNN call computing the same function as K11 on the same
    operands (channels_last, x's dtype): F.conv2d with the (3, 1) or
    (1, 3) kernel, its dilation and bias, relu where `act`; and its
    backward, `aten.convolution_backward` (with the relu mask) -> (fwd,
    bwd) closures. Timed beside the kernel; the port never calls it."""
    import torch.nn.functional as F
    xn = x.permute(0, 3, 1, 2)
    w4 = k.to(x.dtype).permute(2, 1, 0)
    w4 = (w4.unsqueeze(-1) if axis == "h" else w4.unsqueeze(2)).contiguous()
    pad, dil = ((d, 0), (d, 1)) if axis == "h" else ((0, d), (1, d))
    bias = b.to(x.dtype) if b is not None else None
    fwd = lambda: (torch.relu if act else (lambda t: t))(
        F.conv2d(xn, w4, bias, padding=pad, dilation=dil))
    y = fwd()
    dy = torch.randn_like(y)
    bwd = lambda: torch.ops.aten.convolution_backward(
        dy * (y > 0) if act else dy, xn, w4,
        [w4.shape[0]] if b is not None else None, [1, 1], list(pad),
        list(dil), False, [0, 0], 1, [True, True, b is not None])
    return fwd, bwd


def check_k11(dev, g):
    """Phase 2d. `packed_conv_act` forward and backward (dx, dk, db) and
    `packed_conv` forward, dx and dW at every (plane, d, axis) of the
    unfused 256x512 train step at batch 8, and `channel_sums` at its five
    stride-2 and three NB1D planes, in bf16 and in float32, each against
    its plain version, timed beside the plain version and one cuDNN call.
    Returns ({name: {dtype: summary}}, failures)."""
    from lanedetection_end2end_tpu_torch.ops import packed_conv as pc
    from lanedetection_end2end_tpu_torch.ops.tf32x3 import wgrad3_tf32

    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    summary = {n: {dt: dict.fromkeys(K11_KEYS, 0.0)
                   for dt in DTYPE_NAMES.values()}
               for n in ("packed_conv_act", "packed_conv", "channel_sums")}
    failures = []
    for dt, dname in DTYPE_NAMES.items():
        es = torch.finfo(dt).bits // 8
        rate = BF16_FLOP_PER_S if dt == torch.bfloat16 else TF32X3_FLOP_PER_S
        plane_tol = TOL_BF16 if dt == torch.bfloat16 else TOL_F32
        # float32 weight gradients at TOL_F32, beside their control
        dk_tol = () if dt == torch.bfloat16 else (TOL_F32,)
        for shape, d, axis, per_step in k11_cases():
            C, act = shape[-1], axis == "h"
            x = rn(*shape).to(dt)
            k, b = rn(3, C, C) / (3 * C) ** 0.5, 0.1 * rn(C)
            dy, dyc = rn(*shape).to(dt), rn(*shape)
            with torch.no_grad():
                y = pc.packed_conv_act(x, k, b, axis, d, act)
                yc = pc.packed_conv(x, k, axis, d)
                torch.cuda.synchronize()
                py = pc.packed_conv_act_fwd_plain(x, k, b, axis, d, act)
                pyc = pc.packed_conv_fwd_plain(x, k, axis, d)
                # the backward kernels and their plain versions on the same
                # inputs: the plain forward's output
                args = (x, py, dy, k, axis, d, act)
                grads = pc.packed_conv_bwd_kernel(*args)
                cargs = (x, None, dyc.to(dt), k, axis, d, False)
                cgrads = pc.packed_conv_bwd_kernel(*cargs, bias=False)[:2]
                torch.cuda.synchronize()
                pgrads = pc.packed_conv_act_bwd_plain(*args)
                pcgrads = pc.packed_conv_bwd_plain(x, dyc, k, axis, d)
            label = f"{dname} {shape} d={d} axis={axis}"
            if dt == torch.float32:
                with torch.no_grad():
                    tf32_control(f"K11 {label}", [
                        ("dk", grads[1], pgrads[1],
                         pc.packed_conv_act_bwd_plain(
                             *args, wgrad=wgrad3_tf32)[1]),
                        ("dW", cgrads[1], pcgrads[1],
                         pc.packed_conv_bwd_plain(
                             x, dyc, k, axis, d, wgrad=wgrad3_tf32)[1])],
                        failures)
            for name, pairs, fwd, pfwd, bwd, pbwd, lib, act_ in (
                    ("packed_conv_act",
                     [("y", y, py, plane_tol),
                      ("dx", grads[0], pgrads[0], plane_tol),
                      ("dk", grads[1], pgrads[1], *dk_tol),
                      ("db", grads[2], pgrads[2])],
                     lambda: pc.packed_conv_act(x, k, b, axis, d, act),
                     lambda: pc.packed_conv_act_fwd_plain(x, k, b, axis, d,
                                                          act),
                     lambda: pc.packed_conv_bwd_kernel(*args),
                     lambda: pc.packed_conv_act_bwd_plain(*args),
                     library_conv(x, k, b, axis, d, act), act),
                    ("packed_conv",
                     [("y", yc, pyc, TOL_F32),
                      ("dx", cgrads[0], pcgrads[0], plane_tol),
                      ("dW", cgrads[1], pcgrads[1], *dk_tol)],
                     lambda: pc.packed_conv(x, k, axis, d),
                     lambda: pc.packed_conv_fwd_plain(x, k, axis, d),
                     lambda: pc.packed_conv_bwd_kernel(*cargs, bias=False),
                     lambda: pc.packed_conv_bwd_plain(x, dyc, k, axis, d),
                     library_conv(x, k, None, axis, d, False), False)):
                # packed_conv runs on no path: weighted as if the step ran
                # it in place of each of its convolutions
                s = summary[name][dname]
                verdict = hold(f"{name} {label}", pairs, s, failures)
                time_and_record(
                    f"{name} {label}" + ("" if name == "packed_conv" or act
                                         else " (no relu)"),
                    s, per_step, verdict, fwd, pfwd, bwd, pbwd,
                    lambda bwd_, a=act_: k11_work(shape, d, axis, es, a,
                                                  bwd_),
                    flop_per_s=rate)
                with torch.no_grad():
                    l_f, l_b = median_ms(lib[0]), median_ms(lib[1])
                print(f"check {name} {label}: cuDNN F.conv2d "
                      f"{'+ relu ' if act_ else ''}{l_f:.4f} ms, "
                      f"convolution_backward {l_b:.4f} ms")
                s["library_ms"] += per_step * l_f
                s["bwd_library_ms"] += per_step * l_b

        s = summary["channel_sums"][dname]
        p16, p64, p128 = ((BATCH, RESIZE // 2, RESIZE, 16),
                          (BATCH, RESIZE // 4, RESIZE // 2, 64),
                          (BATCH, RESIZE // 8, RESIZE // 4, 128))
        # the five stride-2 blocks (down x3, up x2), then the NB1D
        # BatchNorms per plane, with their launches per unfused step
        for shape, per_step in ((p16, 1), (p64, 1), (p128, 1), (p64, 1),
                                (p16, 1), (p64, 14), (p128, 16), (p16, 4)):
            x = rn(*shape).to(dt)
            got = pc.channel_sums(x)
            torch.cuda.synchronize()
            label = f"channel_sums {dname} {shape}"
            verdict = hold(label, [("sums", got, pc.channel_sums_plain(x),
                                    TOL_F32 if dt == torch.float32
                                    else TOL_REDUCE)], s, failures)
            k_ms = median_ms(lambda: pc.channel_sums(x))
            p_ms = median_ms(lambda: pc.channel_sums_plain(x))
            l_ms = median_ms(lambda: torch.var_mean(x.float(),
                                                    dim=(0, 1, 2)))
            b_ms, by = bound_ms(*sums_work(shape, es))
            print(f"check {label}: {verdict}; kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, var_mean {l_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({by}); x{per_step} per unfused step")
            for key, v in (("ms", k_ms), ("plain_ms", p_ms),
                           ("bound_ms", b_ms), ("library_ms", l_ms)):
                s[key] += per_step * v
        s["max_abs_err"] = s["max_abs_err_reduce"]  # its only outputs are f32
    return summary, failures


class Recording:
    """Stands in for an engine's fitter and keeps the weight maps it was
    given (the masked maps of a real engine call)."""

    def __init__(self, fitter):
        self.fitter, self.maps = fitter, None

    def __call__(self, maps):
        self.maps = maps
        return self.fitter(maps)


def roll_fitter(dev):
    """The fit of the 256x512 config on its BP trapezoid after a camera roll
    of ROLL_DEGREES about the image centre: a general homography."""
    from lanedetection_end2end_tpu_torch.geometry import (
        bev_matrices_pixel, camera_roll)
    from lanedetection_end2end_tpu_torch.ops.wls import WLSFitter
    M = bev_matrices_pixel(RESIZE)[0] @ camera_roll(ROLL_DEGREES, RESIZE,
                                                    RESIZE / 2)
    fit = WLSFitter(M, RESIZE, 2 * RESIZE, 3, normalized=False, reg_ls=1.0,
                    device=dev)
    if fit.separable:
        fail("the rolled homography is separable")
    return fit


class PlainFit:
    """The general fit of `fitter` with its moments from K12's plain
    version: the reference fitter of the f32 LaneNet on the card."""

    def __init__(self, fitter):
        self.fitter = fitter

    def __call__(self, maps):
        from lanedetection_end2end_tpu_torch.ops.wls_moments import (
            wls_moments_plain)
        B, Hm, Wm, C = maps.shape
        moments = wls_moments_plain(maps.float().reshape(B, Hm * Wm, C),
                                    self.fitter.basis)
        return self.fitter._finish(moments, B, C)


def chain_work(x, chain):
    """A chain reads its input plane once and writes its output once; its
    operations are its blocks' taps that land on the plane."""
    from lanedetection_end2end_tpu_torch.ops.nb1d import chain_blocks
    flop = sum(nb1d_work(x, p)[0] for p in chain_blocks(chain))
    return flop, (2 * x.numel() * 2 + chain["w"].numel() * 2
                  + chain["vec"].numel() * 4)


def check_blocks_kernels(dev, g, packed, maps, basis):
    """Phase 2c, the kernels of the blocks-mode engine. `nb1d_chain` at its
    four 256x512 chains and the resize-64 d = 16 edge against its plain
    version (2e-2 of max|plain|) and, bit for bit, against K1 launched
    block by block; `wls_moments` on the masked maps `maps` of a real
    engine call with the rolled homography's `basis`, and at the JAX
    package's three test shapes, against its plain version (1e-4 of
    max|plain|), bit for bit against a second launch, and its gradient
    through autograd against autograd through the plain version (a float64
    einsum, independent of the wrapper's backward). Returns ({name:
    summary}, failures)."""
    from lanedetection_end2end_tpu_torch.ops.nb1d import (
        chain_blocks, nb1d, nb1d_chain, nb1d_chain_plain)
    from lanedetection_end2end_tpu_torch.ops.wls_moments import (
        wls_moments, wls_moments_plain)

    act = lambda *s: torch.randn(*s, generator=g, device=dev).to(
        torch.bfloat16)
    B, H, W = BATCH, RESIZE, 2 * RESIZE
    summary = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "ops_ms": 0.0} for n in BLOCKS}
    summary["nb1d_chain"].update(k1_ms=0.0, library_ms=None)
    failures = []

    def record(s, per_call, k_ms, p_ms, b_ms, by):
        s["ms"] += per_call * k_ms
        s["plain_ms"] += per_call * p_ms
        s["bound_ms"] += per_call * b_ms
        s["ops_ms"] += per_call * b_ms * (by == "operations")

    s = summary["nb1d_chain"]
    for name, shape, per_call in (
            ("enc_nb64", (B, H // 4, W // 4, 64), 1),
            ("enc_nb128", (B, H // 8, W // 8, 128), 1),
            ("dec_nb64", (B, H // 4, W // 4, 64), 1),
            ("dec_nb16", (B, H // 2, W // 2, 16), 1),
            # edge: the resize=64 NB1D-128 plane (8x16), d up to 16 >= H, W
            ("enc_nb128", (2, 8, 16, 128), 0)):
        chain = packed[name]
        x = act(*shape)
        x0 = x.clone()
        got = nb1d_chain(x, chain)
        torch.cuda.synchronize()
        want = nb1d_chain_plain(x, chain)
        k1 = x
        for p in chain_blocks(chain):
            k1 = nb1d(k1, p)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        s["max_abs_err"] = max(s["max_abs_err"], err)
        same = torch.equal(got, k1)
        ok = (got.shape == want.shape and got.dtype == want.dtype
              and torch.isfinite(got.float()).all().item()
              and rel <= TOL_BLOCK and same and torch.equal(x, x0))
        k_ms = median_ms(lambda: nb1d_chain(x, chain))
        p_ms = median_ms(lambda: nb1d_chain_plain(x, chain))

        def blockwise():
            t = x
            for p in chain_blocks(chain):
                t = nb1d(t, p)
        k1_ms = median_ms(blockwise)
        b_ms, by = bound_ms(*chain_work(x, chain))
        label = (f"nb1d_chain {name}{tuple(x.shape)} d="
                 f"{list(chain['dilations'])}")
        print(f"check {label}: max|diff| {err:.3e} ({rel:.2e} of max|plain|, "
              f"tol {TOL_BLOCK:g}), bit for bit equal to K1 block by block: "
              f"{same}, input untouched: {torch.equal(x, x0)}: "
              f"{'ok' if ok else 'FAIL'}; chain {k_ms:.4f} ms, K1 block by "
              f"block {k1_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({by}); x{per_call} per engine call")
        if not ok:
            failures.append(label)
        record(s, per_call, k_ms, p_ms, b_ms, by)
        s["k1_ms"] += per_call * k1_ms

    s = summary["wls_moments"]
    B, Hm, Wm, C = maps.shape
    w = maps.reshape(B, Hm * Wm, C)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    cases = [("engine maps (B, N, C)", w, basis, 1)]
    cases += [(f"JAX test shape {shape}", rn(*shape[:2]),
               rn(shape[1], shape[2]), 0)
              for shape in ((8, 1024, 12), (3, 4096, 30), (32, 2000, 6))]
    for label, w, bas, per_call in cases:
        got = wls_moments(w, bas)
        again = wls_moments(w, bas)
        torch.cuda.synchronize()
        want = wls_moments_plain(w, bas)
        err, rel = rel_err(got, want)
        wg, wp = (w.clone().requires_grad_(True) for _ in range(2))
        gm = rn(*want.shape)
        wls_moments(wg, bas).backward(gm)
        wls_moments_plain(wp, bas).backward(gm)
        gerr, grel = rel_err(wg.grad, wp.grad)
        s["max_abs_err"] = max(s["max_abs_err"], err)
        ok = (got.shape == want.shape and torch.isfinite(got).all().item()
              and rel <= TOL_F32 and grel <= TOL_F32
              and torch.equal(got, again))
        K = bas.shape[1]
        rows, N = got.shape[0], bas.shape[0]
        flop = 2 * rows * N * K + rows * N
        b_ms, by = bound_ms(flop, 4 * (w.numel() + bas.numel() + rows * K),
                            FP32_FLOP_PER_S)
        k_ms = median_ms(lambda: wls_moments(w, bas))
        p_ms = median_ms(lambda: wls_moments_plain(w, bas))
        w3 = w if w.dim() == 3 else w.unsqueeze(-1)
        l_ms = median_ms(lambda: torch.matmul(
            w3.square().permute(0, 2, 1).reshape(rows, N), bas))
        label = f"wls_moments {label} -> {tuple(got.shape)}"
        print(f"check {label}: max|diff| {err:.3e} ({rel:.2e} of max|plain|,"
              f" tol {TOL_F32:g}), gradient against autograd of the plain "
              f"version {grel:.2e}, two launches bit for bit equal: "
              f"{torch.equal(got, again)}: {'ok' if ok else 'FAIL'}; kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, torch.matmul of (BC, N) "
              f"w^2 and the basis (TF32 off) {l_ms:.4f} ms "
              f"({'faster' if l_ms < k_ms else 'slower'} than the kernel), "
              f"bound {b_ms:.4f} ms ({by}); x{per_call} per engine call")
        if not ok:
            failures.append(label)
        record(s, per_call, k_ms, p_ms, b_ms, by)
        if per_call:
            s["library_ms"] = l_ms
    return summary, failures


def serve(engine, packed, images, wrappers):
    """Phase 3 / 3b: the engine on each batch of `images`, the wrappers'
    launch counts set to 0 just before and read just after -> (outputs,
    ms per batch, launches)."""
    for w in wrappers.values():
        w.launches = 0
    outs, batch_ms = [], []
    for x in images:
        t0 = time.perf_counter()
        outs.append(engine(packed, x))
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - t0))
    return outs, batch_ms, {n: w.launches for n, w in wrappers.items()}


def hold_serving(outs, images, model, cfg, label):
    """Hold an engine's outputs against the plain float32 LaneNet `model`
    at the JAX package's bars; returns the worst errors."""
    worst = {"beta": 0.0, "line": 0.0, "horizon": 0.0}
    C = cfg.out_channels
    for (beta, line, hor), x in zip(outs, images):
        ref = model(x)
        n, h = x.shape[:2]
        if (tuple(beta.shape) != (n, C, cfg.order + 1)
                or tuple(line.shape) != (n, 4)
                or tuple(hor.shape) != (n, h)):
            fail(f"{label}: output shapes {beta.shape} {line.shape} "
                 f"{hor.shape}")
        for t in (beta, line, hor):
            if not torch.isfinite(t).all():
                fail(f"{label}: non-finite engine output")
        rel = ((beta - ref.beta).abs().max()
               / ref.beta.abs().max()).item()
        worst["beta"] = max(worst["beta"], rel)
        for key, a, b in (("line", line, ref.line_logits),
                          ("horizon", hor, ref.horizon_logits)):
            excess = ((a - b).abs() - (1e-2 + 1e-2 * b.abs())).max().item()
            worst[key] = max(worst[key], (a - b).abs().max().item())
            if excess > 0:
                fail(f"{label}: {key} logits off the f32 LaneNet by "
                     f"{(a - b).abs().max().item():.3e}")
        if rel >= 3e-2:
            fail(f"{label}: beta relative error {rel:.3e} >= 3e-2")
    print(f"{label} vs f32 LaneNet: beta max rel {worst['beta']:.3e}, line "
          f"max|diff| {worst['line']:.3e}, horizon max|diff| "
          f"{worst['horizon']:.3e}")
    return worst


# ----------------------------------------------------------------------
# Phase 3c: the whole encoder and the whole decoder, one launch each, and
# the row-12 harness
# ----------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(*shape, device="meta")


STAGE_WORK = {"down": down_work, "up": up_work, "nb1d": nb1d_work,
              "head": head_work}


def stages_flop(p, stages, shape):
    """The operations of the fused kernel's stages run on `shape`, each
    stage on the shape the one before it gives."""
    from lanedetection_end2end_tpu_torch.ops.backbone_fused import (
        stage, stage_kind)
    flop = 0
    for key in stages:
        kind, q = stage_kind(key), stage(p, key)
        flop += STAGE_WORK[kind](_meta(*shape), q)[0]
        B, H, W, _ = shape
        if kind == "down":
            shape = (B, H // 2, W // 2, q["mul"].numel())
        elif kind == "up":
            shape = (B, 2 * H, 2 * W, q["w"].shape[-1])
    return flop


def encoder_work(p, B, H, W):
    """The whole encoder on (B, H, W, 3): its stages' operations; bytes
    that must cross HBM: the image, the constants and enc, once each."""
    from lanedetection_end2end_tpu_torch.ops.backbone_fused import ENC_STAGES
    nbytes = (2 * B * H * W * 3 + 2 * p["wbuf"].numel()
              + 4 * p["vbuf"].numel() + 2 * B * (H // 8) * (W // 8) * 128)
    return stages_flop(p, ENC_STAGES, (B, H, W, 3)), nbytes


def decoder_work(p, B, H, W):
    """The whole decoder to S (B, H, 2C): its stages' operations; bytes
    that must cross HBM: enc, the constants and S, once each."""
    from lanedetection_end2end_tpu_torch.ops.backbone_fused import DEC_STAGES
    C = p["head"]["bias"].numel()
    nbytes = (2 * B * (H // 8) * (W // 8) * 128 + 2 * p["wbuf"].numel()
              + 4 * p["vbuf"].numel() + 4 * B * H * 2 * C)
    return stages_flop(p, DEC_STAGES, (B, H // 8, W // 8, 128)), nbytes


# grid barriers per call of each fused kernel, one between each pair of its
# passes: the encoder's 3 stride-2 passes and 13 NB1D blocks of 2 passes,
# the decoder's 2 stride-2 passes, 4 NB1D blocks of 2 passes and the head
FUSED_BARRIERS = {"encoder_fused": 28, "decoder_fused": 10}
MIN_WARPS_PER_SM = 16  # twice the 8 of the fused kernels' first design


def fused_occupancy(dev, packed, x, enc_b, failures, where=""):
    """Phases 3c and 3d (`where`: " wide"): one line per fused kernel with
    what the card gives its launch at the engine's shape, the build of
    whole rows at 256x512 and that of segments at 512x1024
    (`ops/backbone_fused.py::fused_info`:
    registers and local bytes a thread from cudaFuncGetAttributes, blocks
    and warps resident per SM, grid) and the grid barriers the kernel
    counted in one more call; no local memory, at least MIN_WARPS_PER_SM
    warps per SM and FUSED_BARRIERS barriers, or a failure. Returns {name:
    info}."""
    from lanedetection_end2end_tpu_torch.ops.backbone_fused import (
        decoder_fused_kernel, encoder_fused_kernel, fused_info)
    B, H, W, _ = x.shape
    out = {}
    for name, which, p, run in (
            ("encoder_fused", "encoder", packed["enc"],
             lambda: encoder_fused_kernel(x, packed["enc"])),
            ("decoder_fused", "decoder", packed["dec"],
             lambda: decoder_fused_kernel(enc_b, packed["dec"]))):
        info = fused_info(which, p, B, H, W, dev)
        run()
        wrapper = (encoder_fused_kernel if which == "encoder"
                   else decoder_fused_kernel)
        barriers = wrapper.barriers.item()
        ok = (barriers == FUSED_BARRIERS[name] and info["local_bytes"] == 0
              and info["warps_per_sm"] >= MIN_WARPS_PER_SM)
        print(f"occupancy {name}{where}: {info['registers']} registers and "
              f"{info['local_bytes']} local bytes a thread, "
              f"{info['blocks_per_sm']} blocks of {info['threads']} threads "
              f"({info['warps_per_sm']} warps) per SM, grid {info['grid']} "
              f"blocks on {info['sms']} SMs, {info['smem_bytes']} bytes of "
              f"shared memory a block, {barriers} grid barriers per call "
              f"(expected {FUSED_BARRIERS[name]}; no local memory, at least "
              f"{MIN_WARPS_PER_SM} warps per SM): {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name}{where} occupancy")
        out[name] = dict(info, barriers=barriers)
    return out


def stage_label(kind, x, q):
    """The block-sequence kernel a stage calls, with its shape."""
    if kind in ("down", "up"):
        cout = (q["mul"].numel() if kind == "down" else q["w"].shape[-1])
        return f"{'K2' if kind == 'down' else 'K3'} {x.shape[-1]}->{cout}"
    if kind == "nb1d":
        return f"K1 C={x.shape[-1]} d={q['dilation']}"
    return "K4"


def time_block_stages(packed, x, fused_ms):
    """Phase 3c: the block sequence (`encoder_blocks`, `decoder_blocks`)
    timed stage by stage, each wrapper call of K1-K4 on its own input
    (CUDA events, median of 20), so the fused kernels' time splits by
    stage; then cuDNN's products alone at the serving stride-2 shapes
    (`library` lines: bf16 channels_last `F.conv2d` 3x3/s2/p1 beside K2,
    `F.conv_transpose2d` 3x3/s2/p1/op1 beside K3), as phase 2b's lines
    sit beside K8 / K9. Returns ({part: {label: ms}}, {kernel: library ms per
    engine call})."""
    import torch.nn.functional as F
    from lanedetection_end2end_tpu_torch.models.fused_graph import BLOCKS
    from lanedetection_end2end_tpu_torch.ops.backbone_fused import (
        DEC_STAGES, ENC_STAGES, stage, stage_kind)
    stages_ms, library = {}, {"downsampler": 0.0, "upsampler": 0.0}
    for part, name, stages in (("enc", "encoder_fused", ENC_STAGES),
                               ("dec", "decoder_fused", DEC_STAGES)):
        by, counts = {}, {}
        for key in stages:
            kind, q = stage_kind(key), stage(packed[part], key)
            op, xin = BLOCKS[kind], x
            label = stage_label(kind, xin, q)
            k_ms = median_ms(lambda: op(xin, q))
            by[label] = by.get(label, 0.0) + k_ms
            counts[label] = counts.get(label, 0) + 1
            if kind in ("down", "up"):
                xn = xin.permute(0, 3, 1, 2)  # channels_last NCHW view
                if kind == "down":
                    wl = q["w"].permute(3, 2, 0, 1).contiguous(
                        memory_format=torch.channels_last)
                    lib = lambda: F.conv2d(xn, wl, stride=2, padding=1)
                    call = "F.conv2d 3x3/s2/p1"
                else:
                    wl = q["w"].permute(2, 3, 0, 1).contiguous(
                        memory_format=torch.channels_last)
                    lib = lambda: F.conv_transpose2d(
                        xn, wl, stride=2, padding=1, output_padding=1)
                    call = "F.conv_transpose2d 3x3/s2/p1/op1"
                with torch.no_grad():
                    l_ms = median_ms(lib)
                library["downsampler" if kind == "down"
                        else "upsampler"] += l_ms
                print(f"library {label} {tuple(xin.shape)}: cuDNN {call} "
                      f"alone, bf16 channels_last, {l_ms:.4f} ms ({label} "
                      f"{k_ms:.4f} ms, {k_ms / l_ms:.2f}x)")
            x = op(x, q)
        total = sum(by.values())
        print(f"{name} block sequence by stage (ms per engine call, "
              f"wrapper calls timed one by one): "
              + ", ".join(f"{k} x{counts[k]} {v:.4f}" for k, v in by.items())
              + f"; sum {total:.4f}, the fused kernel {fused_ms[name]:.4f} "
              f"({fused_ms[name] / total:.2f} of the sum)")
        stages_ms[name] = by
    return stages_ms, library


def check_fused_backbone(dev, g, sd, packed, images):
    """Phase 3c. The block path (`encoder_blocks` -> `decoder_blocks`, 23
    wrapper calls of K1-K4) on the engine's batches with the launch counts
    set to 0 just before and read just after; then `encoder_fused` and
    `decoder_fused` bit for bit against it on every batch (the decoder on
    the block path's features) and on EDGE_BATCHES batches at the
    resize-64 edge (the 8x16 NB1D-128 plane, d = 16 >= H, W), on each
    against their plain versions (enc at
    TOL_BLOCK, S at TOL_S, beside the control that TOL_S must catch), and
    timed beside the block sequence and the bound. Returns
    ({name: summary}, block-path launches, failures)."""
    from lanedetection_end2end_tpu_torch.config import train_sh_config
    from lanedetection_end2end_tpu_torch.models.fused_graph import (
        decoder_blocks, encoder_blocks, pack_decoder)
    from lanedetection_end2end_tpu_torch.models.lanenet import make_fitter
    from lanedetection_end2end_tpu_torch.ops import backbone as bb
    from lanedetection_end2end_tpu_torch.ops.backbone_fused import (
        decoder_fused_kernel, decoder_plain, encoder_fused_kernel,
        encoder_plain)
    from lanedetection_end2end_tpu_torch.ops.nb1d import nb1d

    wrappers = {"nb1d": nb1d, "downsampler": bb.downsampler,
                "upsampler": bb.upsampler, "head_rowsums": bb.head_rowsums}
    failures = []
    for w in wrappers.values():
        w.launches = 0
    refs = []
    for x in images:
        e = encoder_blocks(x, packed["enc"])
        refs.append((x.to(torch.bfloat16).contiguous(), e,
                     decoder_blocks(e, packed["dec"])))
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    per_call = {"nb1d": 17, "downsampler": 3, "upsampler": 2,
                "head_rowsums": 1}
    print(f"block path (encoder_blocks, decoder_blocks) launches over "
          f"{len(images)} calls: {launches}")
    if launches != {n: len(images) * v for n, v in per_call.items()}:
        failures.append(f"block path launches {launches}, expected "
                        f"{per_call} per call")

    cfg64 = train_sh_config(resize=64, reg_ls=1.0)
    dec64 = pack_decoder(sd, cfg64, make_fitter(cfg64, dev))
    refs_edge = []
    for _ in range(EDGE_BATCHES):
        xe = torch.rand(2, 64, 128, 3, generator=g, device=dev).to(
            torch.bfloat16).contiguous()
        enc_e = encoder_blocks(xe, packed["enc"])
        refs_edge.append((xe, enc_e, decoder_blocks(enc_e, dec64)))
    summary = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "ops_ms": 0.0, "blocks_ms": 0.0,
                   "library_ms": None}
               for n in ("encoder_fused", "decoder_fused")}
    for label, cases, dec, timed in (
            (f"{BATCH}x{RESIZE}x{2 * RESIZE}", refs, packed["dec"], True),
            ("resize-64 edge", refs_edge, dec64, False)):
        # the control: the plain decoder with every logit 1 + 2^-8 times
        # too large, which the bar on S must catch
        head = dec["head"]
        up = 1 + 2 ** -8
        dec_c = dict(dec, head=dict(head, w=head["w"].float() * up,
                                    bias=head["bias"] * up))
        control = float("inf")
        seen = {n: {"same": True, "sound": True, "err": 0.0, "rel": 0.0}
                for n in summary}
        for x, enc_b, S_b in cases:
            S_p = decoder_plain(enc_b, dec)
            control = min(control, rel_err(decoder_plain(enc_b, dec_c),
                                           S_p)[1])
            for name, got, ref, want in (
                    ("encoder_fused", encoder_fused_kernel(x, packed["enc"]),
                     enc_b, encoder_plain(x, packed["enc"])),
                    ("decoder_fused", decoder_fused_kernel(enc_b, dec), S_b,
                     S_p)):
                err, rel = rel_err(got, want)
                v = seen[name]
                v["same"] &= torch.equal(got, ref)
                v["sound"] &= (got.shape == want.shape
                               and got.dtype == want.dtype
                               and torch.isfinite(got.float()).all().item())
                v["err"], v["rel"] = max(v["err"], err), max(v["rel"], rel)
        x, enc_b, _ = cases[0]
        for name, tol, work, fused, blocks, plain in (
                ("encoder_fused", TOL_BLOCK, encoder_work,
                 lambda: encoder_fused_kernel(x, packed["enc"]),
                 lambda: encoder_blocks(x, packed["enc"]),
                 lambda: encoder_plain(x, packed["enc"])),
                ("decoder_fused", TOL_S, decoder_work,
                 lambda: decoder_fused_kernel(enc_b, dec),
                 lambda: decoder_blocks(enc_b, dec),
                 lambda: decoder_plain(enc_b, dec))):
            v, s = seen[name], summary[name]
            ok = v["same"] and v["sound"] and v["rel"] <= tol
            s["max_abs_err"] = max(s["max_abs_err"], v["err"])
            line = (f"check {name} {label}: bit for bit equal to the block "
                    f"sequence on {len(cases)} batch(es): {v['same']}; "
                    f"largest max|diff| vs plain {v['err']:.3e} "
                    f"({v['rel']:.2e} of max|plain|, tol {tol:g})")
            if name == "decoder_fused":
                caught = control > tol
                ok &= caught
                line += (f"; control, logits x (1 + 2^-8): least "
                         f"{control:.2e} of max|plain|, "
                         f"{'' if caught else 'NOT '}above the tol")
            line += f": {'ok' if ok else 'FAIL'}"
            if timed:
                B, H, W, _ = x.shape
                k_ms, b_ms, p_ms = (median_ms(f)
                                    for f in (fused, blocks, plain))
                bnd, by = bound_ms(*work(packed["enc"] if name ==
                                         "encoder_fused" else dec, B, H, W))
                s.update(ms=k_ms, blocks_ms=b_ms, plain_ms=p_ms,
                         bound_ms=bnd, ops_ms=bnd * (by == "operations"))
                line += (f"; fused {k_ms:.4f} ms, block sequence {b_ms:.4f}"
                         f" ms, plain {p_ms:.4f} ms, bound {bnd:.4f} ms "
                         f"({by}); x1 per engine call")
            print(line)
            if not ok:
                failures.append(f"{name} {label}")
    x, enc_b, _ = refs[0]
    occupancy = fused_occupancy(dev, packed, x, enc_b, failures)
    stages_ms, library = time_block_stages(
        packed, x, {n: s["ms"] for n, s in summary.items()})
    for n, s in summary.items():
        s.update(occupancy=occupancy[n], stage_ms=stages_ms[n])
    return summary, launches, library, failures


def check_row12(dev):
    """Phase 3c, last: the row-12 harness
    (`lanedetection_end2end_tpu_torch/tools/prof_block_stack.py`) at
    --bs 32 --reps 8 --stacks 1,2,4: one pass at each stack with the
    `nb1d_chain` count set to 0 just before and read just after (32 + 16 +
    8 launches), the stacked outputs bit for bit the S = 1 outputs and
    within TOL_BLOCK of the plain chain, then block-img/s per stack as the
    JAX tool prints it. Returns (summary, launches, failures)."""
    from lanedetection_end2end_tpu_torch.ops.nb1d import (
        nb1d_chain, nb1d_chain_plain)
    from lanedetection_end2end_tpu_torch.tools.prof_block_stack import (
        block_img_per_s, run_stacked, setup)
    bs, reps, stacks = 32, 8, (1, 2, 4)
    x, chain = setup(bs, reps, dev)
    nb1d_chain.launches = 0
    outs = {s: run_stacked(x, chain, s) for s in stacks}
    torch.cuda.synchronize()
    launches = nb1d_chain.launches
    equal = all(torch.equal(outs[s], outs[1]) for s in stacks)
    err, rel = rel_err(outs[1], nb1d_chain_plain(x, chain))
    ok = (equal and launches == sum(bs // s for s in stacks)
          and torch.isfinite(outs[1].float()).all().item()
          and rel <= TOL_BLOCK)
    print(f"check row12 harness (nb1d_chain, {reps} x NB1D-128 d=2 on "
          f"{tuple(x.shape)}): {launches} launches, stacks {stacks} bit for "
          f"bit equal: {equal}, max|diff| vs plain {err:.3e} ({rel:.2e} of "
          f"max|plain|, tol {TOL_BLOCK:g}): {'ok' if ok else 'FAIL'}")
    rates = {s: block_img_per_s(x, chain, s) for s in stacks}
    for s in stacks:
        print(f"BS={bs} REPS={reps} STACK={s}: {rates[s]:.1f} block-img/s")
    k_ms = median_ms(lambda: run_stacked(x, chain, 1))
    p_ms = median_ms(lambda: nb1d_chain_plain(x, chain))
    b_ms, by = bound_ms(*chain_work(x, chain))
    print(f"row12: {bs} launches of 1 image {k_ms:.4f} ms, plain {p_ms:.4f} "
          f"ms, bound {b_ms:.4f} ms ({by})")
    summary = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": b_ms, "ops_ms": b_ms * (by == "operations"),
               "library_ms": None,
               "block_img_per_s": {str(s): r for s, r in rates.items()}}
    return summary, launches, [] if ok else ["row12 harness"]


# ----------------------------------------------------------------------
# Wide phase: images wider than the NB1D row tiles
# ----------------------------------------------------------------------

WIDE_RESIZE, WIDE_BATCH = 512, 2  # 512x1024 images, batches of 2


def check_wide(dev):
    """The wide phase. The engine of `train_sh_config(resize=512)` on 2
    batches of 2 seeded 512x1024 images, whose NB1D rows are wider than a
    row tile (NB1D-128 rows of 128 pixels on 64-pixel tiles, NB1D-64 of 256
    on 128, NB1D-16 of 512 on 256: two segments a row): the full path and
    the blocks path, each with the launch counts set to 0 just before and
    read just after (per call 1 + 1 fused kernels, or 4 chains), held to
    the plain float32 `LaneNet` at the JAX bars; `encoder_fused` and
    `decoder_fused` bit for bit their block sequence on the first batch and
    against their plain versions (TOL_BLOCK, TOL_S), and the occupancy
    line of their segments' build (`fused_occupancy`); then K1 at each
    channel count and one `nb1d_chain` against their plain versions at
    rows wider than a tile (the engine's planes, and W = MT + 16: a partial
    last segment), the chain also bit for bit K1 block by block. Returns
    (summary, failures)."""
    from lanedetection_end2end_tpu_torch.config import train_sh_config
    from lanedetection_end2end_tpu_torch.models.fused_graph import (
        decoder_blocks, encoder_blocks)
    from lanedetection_end2end_tpu_torch.models.infer_engine import (
        FusedLaneNetEngine)
    from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
    from lanedetection_end2end_tpu_torch.ops.backbone_fused import (
        decoder_fused_kernel, decoder_plain, encoder_fused_kernel,
        encoder_plain)
    from lanedetection_end2end_tpu_torch.ops.nb1d import (
        chain_blocks, nb1d, nb1d_chain, nb1d_chain_plain, nb1d_plain)

    R = WIDE_RESIZE
    cfg = train_sh_config(resize=R, reg_ls=1.0)
    model = LaneNet(cfg, device=dev)
    model.load_state_dict(random_state_dict(model, SEED))
    engine = FusedLaneNetEngine(cfg)
    packed = engine.prepare(model.state_dict())
    gw = torch.Generator(device=dev).manual_seed(SEED + 3)
    images = torch.rand(2, WIDE_BATCH, R, 2 * R, 3, generator=gw, device=dev)
    wrappers = {"encoder_fused": encoder_fused_kernel,
                "decoder_fused": decoder_fused_kernel,
                "nb1d_chain": nb1d_chain, "nb1d": nb1d}
    failures, summary = [], {}
    blocks = lambda p, x: engine._run(p, x, blocks=True)
    for label, call, per_call in (
            ("wide engine", engine, {"encoder_fused": 1, "decoder_fused": 1,
                                     "nb1d_chain": 0, "nb1d": 0}),
            ("wide blocks engine", blocks,
             {"encoder_fused": 0, "decoder_fused": 0, "nb1d_chain": 4,
              "nb1d": 0})):
        call(packed, images[0])  # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        outs, ms, counts = serve(call, packed, images, wrappers)
        print(f"{label} {WIDE_BATCH}x{R}x{2 * R}: launches over "
              f"{len(images)} calls: {counts}")
        if counts != {n: len(images) * v for n, v in per_call.items()}:
            failures.append(f"{label}: launches {counts}, expected "
                            f"{per_call} per call")
        worst = hold_serving(outs, images, model, cfg, label)
        med = statistics.median(ms)
        print(f"{label}: {med:.3f} ms per batch of {WIDE_BATCH} "
              f"({', '.join(f'{t:.3f}' for t in ms)})")
        summary[label.replace(" ", "_")] = dict(worst, ms_per_batch=med)

    # the fused kernels against their block sequence and plain versions
    x = images[0].to(torch.bfloat16).contiguous()
    enc_f = encoder_fused_kernel(x, packed["enc"])
    enc_b = encoder_blocks(x, packed["enc"])
    S_f = decoder_fused_kernel(enc_b, packed["dec"])
    S_b = decoder_blocks(enc_b, packed["dec"])
    torch.cuda.synchronize()
    for name, got, ref, want, tol, run in (
            ("encoder_fused", enc_f, enc_b, encoder_plain(x, packed["enc"]),
             TOL_BLOCK, lambda: encoder_fused_kernel(x, packed["enc"])),
            ("decoder_fused", S_f, S_b, decoder_plain(enc_b, packed["dec"]),
             TOL_S, lambda: decoder_fused_kernel(enc_b, packed["dec"]))):
        err, rel = rel_err(got, want)
        same = torch.equal(got, ref)
        ok = (same and rel <= tol and got.shape == want.shape
              and torch.isfinite(got.float()).all().item())
        k_ms = median_ms(run)
        print(f"check {name} wide {tuple(x.shape)}: bit for bit equal to the "
              f"block sequence: {same}; max|diff| vs plain {err:.3e} "
              f"({rel:.2e} of max|plain|, tol {tol:g}): "
              f"{'ok' if ok else 'FAIL'}; fused {k_ms:.4f} ms")
        if not ok:
            failures.append(f"{name} wide")
        summary[name] = {"bit_for_bit": same, "max_rel_err": rel,
                         "ms": k_ms}
    occupancy = fused_occupancy(dev, packed, x, enc_b, failures, " wide")
    for name, info in occupancy.items():
        summary[name]["occupancy"] = info

    # K1 and a chain at rows wider than a tile (MT = 64, 128, 256 pixels at
    # C = 128, 64, 16), the engine's planes and a partial last segment
    act = lambda *shp: torch.randn(*shp, generator=gw, device=dev).to(
        torch.bfloat16)
    enc, dec = packed["enc"], packed["dec"]
    H4, H8 = R // 4, R // 8
    for shape, p in (((WIDE_BATCH, H8, R // 4, 128), enc["nb128"][0]),
                     ((2, 8, 64 + 16, 128), enc["nb128"][3]),
                     ((WIDE_BATCH, H4, R // 2, 64), enc["nb64"][0]),
                     ((2, 8, 128 + 16, 64), dec["nb64"][1]),
                     ((WIDE_BATCH, R // 2, R, 16), dec["nb16"][0]),
                     ((2, 8, 256 + 16, 16), dec["nb16"][1])):
        xk = act(*shape)
        got = nb1d(xk, p)
        torch.cuda.synchronize()
        err, rel = rel_err(got, nb1d_plain(xk, p))
        ok = rel <= TOL_BF16 and torch.isfinite(got.float()).all().item()
        print(f"check nb1d wide {shape} d={p['dilation']}: max|diff| "
              f"{err:.3e} ({rel:.2e} of max|plain|, tol {TOL_BF16:g}): "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"nb1d wide {shape}")
    chain = packed["enc_nb128"]
    xk = act(2, 8, 64 + 16, 128)
    got = nb1d_chain(xk, chain)
    k1 = xk
    for p in chain_blocks(chain):
        k1 = nb1d(k1, p)
    torch.cuda.synchronize()
    err, rel = rel_err(got, nb1d_chain_plain(xk, chain))
    same = torch.equal(got, k1)
    ok = same and rel <= TOL_BLOCK
    print(f"check nb1d_chain wide enc_nb128{tuple(xk.shape)}: max|diff| "
          f"{err:.3e} ({rel:.2e} of max|plain|, tol {TOL_BLOCK:g}), bit for "
          f"bit equal to K1 block by block: {same}: {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("nb1d_chain wide")
    return summary, failures


# ----------------------------------------------------------------------
# Race check: the row tile under compute-sanitizer
# ----------------------------------------------------------------------

SANITIZER_TOOLS = ("racecheck", "synccheck")
SANITIZER_TIMEOUT = 300  # seconds per tool
# the tool's own refusal of the card, which runs no check
SANITIZER_REFUSAL = "Device not supported"


def race_child() -> int:
    """`--race-child`, the program the race check runs under
    compute-sanitizer: one `encoder_fused`, one `decoder_fused` and one
    `nb1d_chain` call at resize 64 (batch 2, seeded random weights), and
    one more `nb1d_chain` call on rows wider than its tile (1x4x80 at C =
    128: a full and a partial segment)."""
    from lanedetection_end2end_tpu_torch.config import train_sh_config
    from lanedetection_end2end_tpu_torch.models.infer_engine import (
        FusedLaneNetEngine)
    from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
    from lanedetection_end2end_tpu_torch.ops.backbone_fused import (
        decoder_fused_kernel, encoder_fused_kernel)
    from lanedetection_end2end_tpu_torch.ops.nb1d import nb1d_chain
    dev = torch.device("cuda", 0)
    cfg = train_sh_config(resize=64, reg_ls=1.0)
    model = LaneNet(cfg, device="cpu")
    engine = FusedLaneNetEngine(cfg, device=dev)
    packed = engine.prepare(random_state_dict(model, SEED))
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    x = torch.rand(2, 64, 128, 3, generator=g, device=dev).to(torch.bfloat16)
    enc = encoder_fused_kernel(x, packed["enc"])
    S = decoder_fused_kernel(enc, packed["dec"])
    y = nb1d_chain(enc, packed["enc_nb128"])
    wide = torch.randn(1, 4, 80, 128, generator=g, device=dev).to(
        torch.bfloat16)
    z = nb1d_chain(wide, packed["enc_nb128"])
    torch.cuda.synchronize()
    finite = all(torch.isfinite(t.float()).all().item() for t in (S, y, z))
    print(f"race child: outputs finite: {finite}")
    return 0 if finite else 1


def sanitizer_verdict(rc, text: str) -> str:
    """What one compute-sanitizer run found: "not run" where the tool
    refused the card (SANITIZER_REFUSAL), "clean" where it exited 0 and
    every RACECHECK / ERROR SUMMARY line of its output counts 0, else
    "fail" (a hazard, an error, a child that failed, or rc None: the run
    timed out)."""
    import re
    if SANITIZER_REFUSAL in text:
        return "not run"
    counts = re.findall(r"(?:RACECHECK|ERROR) SUMMARY: (\d+)", text)
    return "clean" if rc == 0 and not any(map(int, counts)) else "fail"


def race_check():
    """The race-check phase: `race_child` in a child process under
    compute-sanitizer's racecheck (shared-memory hazards) and synccheck
    (barrier misuse), each with --error-exitcode 1 and judged by
    `sanitizer_verdict`: "fail" fails the run. The tool is looked for
    beside nvcc, then on PATH; where there is none, or it refuses the card,
    the report says so and no race check is claimed. Returns (report,
    failures)."""
    import os
    import shutil
    import signal
    from lanedetection_end2end_tpu_torch.ops._build import _nvcc
    tool = os.path.join(os.path.dirname(_nvcc()), "compute-sanitizer")
    if not os.path.exists(tool):
        tool = shutil.which("compute-sanitizer")
    if tool is None:
        msg = "not run: compute-sanitizer not found beside nvcc or on PATH"
        print(f"race check: {msg}")
        return {"tool": None, "result": msg}, []
    report, failures = {"tool": tool}, []
    for name in SANITIZER_TOOLS:
        t0 = time.perf_counter()
        cmd = [tool, "--tool", name, "--error-exitcode", "1",
               sys.executable, os.path.abspath(__file__), "--race-child"]
        # its own process group, so that a timeout stops the tool and the
        # program under it together
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            text, _ = proc.communicate(timeout=SANITIZER_TIMEOUT)
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            text, _ = proc.communicate()
            rc = None
        verdict = sanitizer_verdict(rc, text)
        said = [ln.strip("= ").strip() for ln in text.splitlines()
                if SANITIZER_REFUSAL in ln or "SUMMARY" in ln]
        result = (f"{verdict} (exit {rc}"
                  f"{', timed out' if rc is None else ''}"
                  f"{': ' + '; '.join(said) if said else ''})")
        print(f"race check {name}: {result} "
              f"({time.perf_counter() - t0:.1f} s)")
        if verdict == "fail":
            failures.append(f"compute-sanitizer --tool {name}: {result}")
            print(text[-3000:])
        report[name] = {"result": verdict, "exit": rc, "said": said,
                        "seconds": time.perf_counter() - t0}
    return report, failures


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
             "head_rowsums_op", "channel_sums", "packed_conv_act",
             "packed_conv")


def _per_step(**launches):
    """Wrapper launches per step, (forward, backward), 0 for the rest;
    channel_sums has no backward kernel."""
    return {n: launches.get(n, (0, 0)) for n in TRAIN_OPS}


# the four training paths, {fused_blocks} x {fused_maps}: "fused" (the
# default, both on), "maps off" (fused_blocks with fused_maps=False),
# "unfused" (fused_blocks=False, fused_maps following it) and "unfused
# maps on" (fused_blocks=False with fused_maps=True)
PER_STEP = {
    "fused": _per_step(nb_half_a=(17, 17), nb_half_b=(17, 17),
                       downsampler_op=(3, 3), lane_maps_op=(2, 2),
                       head_rowsums_op=(1, 1)),
    "maps off": _per_step(nb_half_a=(17, 17), nb_half_b=(17, 17),
                          channel_sums=(5, 0)),
    "unfused": _per_step(packed_conv_act=(68, 68), channel_sums=(39, 0)),
    "unfused maps on": _per_step(packed_conv_act=(68, 68),
                                 channel_sums=(34, 0), downsampler_op=(3, 3),
                                 lane_maps_op=(2, 2), head_rowsums_op=(1, 1))}
# the eval step: no backward, running statistics; the head on
# lane_maps_op with fused maps, no fused tail
PER_EVAL = {
    "fused": _per_step(nb_half_a=(17, 0), nb_half_b=(17, 0),
                       downsampler_op=(3, 0), lane_maps_op=(3, 0)),
    "unfused": _per_step(packed_conv_act=(68, 0))}
# calls of torch.nn.functional per train step: the two heads' eight
# convolutions and the line head's pool; with fused_maps off also the
# backbone's three downsamplers, two upsamplers and output head
F_CALLS = {"fused": {"conv2d": 8, "max_pool2d": 1, "conv_transpose2d": 0},
           "maps off": {"conv2d": 11, "max_pool2d": 4,
                        "conv_transpose2d": 3}}
F_CALLS["unfused"] = F_CALLS["maps off"]
F_CALLS["unfused maps on"] = F_CALLS["fused"]


def train_wrappers():
    from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
    from lanedetection_end2end_tpu_torch.ops import nb_block as nb
    from lanedetection_end2end_tpu_torch.ops import packed_conv as pc
    return {"nb_half_a": nb.nb_half_a, "nb_half_b": nb.nb_half_b,
            "downsampler_op": lm.downsampler_op,
            "lane_maps_op": lm.lane_maps_op,
            "head_rowsums_op": lm.head_rowsums_op,
            "channel_sums": pc.channel_sums,
            "packed_conv_act": pc.packed_conv_act,
            "packed_conv": pc.packed_conv}


def reset_counts(wrappers):
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "bwd_launches"):
            w.bwd_launches = 0


def read_counts(wrappers):
    return {n: (w.launches, getattr(w, "bwd_launches", 0))
            for n, w in wrappers.items()}


def whole(grads):
    return torch.cat(list(grads.values()))


def cosine(a, b):
    a, b = a.double(), b.double()
    return (torch.dot(a, b) / (a.norm() * b.norm())).item()


class Trainer:
    """The train_sh config at 256x512 in one compute dtype on one training
    path of the card (`fused_blocks`), seeded weights `sd0`, and the steps
    of phases 4 and 4d on it."""

    def __init__(self, dev, sd0, dtype: str, fused_blocks: bool):
        from lanedetection_end2end_tpu_torch.config import train_sh_config
        from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
        self.cfg = train_sh_config(resize=RESIZE, reg_ls=1.0,
                                   compute_dtype=dtype)
        self.model = LaneNet(self.cfg, device=dev)
        self.sd0, self.dev, self.fused_blocks = sd0, dev, fused_blocks
        self.batch = synthetic_batch(SEED + 3)
        self.label = f"{dtype}, fused_blocks={fused_blocks}"

    def fresh_step(self, sd=None, fused_maps=None):
        from lanedetection_end2end_tpu_torch.train.optim import define_optim
        from lanedetection_end2end_tpu_torch.train.steps import (
            make_train_step)
        cfg = self.cfg
        self.model.load_state_dict(self.sd0 if sd is None else sd)
        opt = define_optim(self.model.parameters(), cfg.optimizer,
                           cfg.learning_rate, cfg.weight_decay,
                           cfg.clip_grad_norm)
        return make_train_step(self.model, cfg, opt,
                               fused_blocks=self.fused_blocks,
                               fused_maps=fused_maps)

    def one_step(self, step, generator, batch=None):
        """-> (loss, {name: gradient}, ms of the step)."""
        t0 = time.perf_counter()
        metrics = step(self.batch if batch is None else batch, generator)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        grads = {k: p.grad.float().flatten().clone()
                 for k, p in self.model.named_parameters()
                 if p.grad is not None}
        return metrics["loss"].item(), grads, ms

    def kernels_vs_plain(self, sd=None, batch=None):
        """One step with dropout off on the kernels and one on their plain
        versions -> (loss_k, grads_k, loss_p, grads_p)."""
        loss_k, g_k, _ = self.one_step(self.fresh_step(sd), None, batch)
        with plain_versions():
            loss_p, g_p, _ = self.one_step(self.fresh_step(sd), None, batch)
        return loss_k, g_k, loss_p, g_p

    def hold_bf16(self):
        """Phase 4a: the bf16 step on the kernels against the step on their
        plain versions (see the docstring for the bars)."""
        loss_k, g_k, loss_p, g_p = self.kernels_vs_plain()
        rel = abs(loss_k - loss_p) / abs(loss_p)
        near = {k: (cosine(g_k[k], g_p[k]),
                    (g_k[k].norm() / g_p[k].norm()).item())
                for k in g_p if k.startswith(NEAR_LOSS + SHOWN)}
        ratio = (whole(g_k).norm() / whole(g_p).norm()).item()
        print(f"train step ({self.label}), kernels vs plain versions, seeded "
              f"weights: loss {loss_k:.6g} vs {loss_p:.6g} (rel {rel:.3e}); "
              f"gradient (cosine, norm ratio) of the leaves next to the "
              f"loss: " + ", ".join(f"{k} ({c:.6f}, {r:.5f})"
                                    for k, (c, r) in near.items())
              + f"; whole gradient cosine "
              f"{cosine(whole(g_k), whole(g_p)):.4f}, norm ratio {ratio:.4f} "
              f"(the decoder's output convolution and the whole gradient are "
              f"not held, see the docstring)")
        held = [v for k, v in near.items() if k.startswith(NEAR_LOSS)]
        if (len(held) != 4 or rel > 1e-2
                or not torch.isfinite(whole(g_k)).all().item()
                or any(c <= COS_HEADS or not 0.9 < r < 1.1 for c, r in held)):
            fail(f"the {self.label} train step on the kernels disagrees "
                 "with the step on their plain versions (seeded weights)")

        # The residual branches damped: the whole gradient, against the
        # plain step's own cosine under a one-pixel change of the input.
        damped = self.damped()
        nudged = dict(self.batch, image=self.batch["image"].clone())
        nudged["image"][0, RESIZE // 2, RESIZE, 0] ^= 1
        loss_k, g_k, loss_p, g_p = self.kernels_vs_plain(damped)
        with plain_versions():
            _, g_n, _ = self.one_step(self.fresh_step(damped), None, nudged)
        g_k, g_p, g_n = whole(g_k), whole(g_p), whole(g_n)
        cos, yardstick = cosine(g_k, g_p), cosine(g_p, g_n)
        ratio = (g_k.norm() / g_p.norm()).item()
        rel = abs(loss_k - loss_p) / abs(loss_p)
        print(f"train step ({self.label}), kernels vs plain versions, bn2 "
              f"scales x {BN2_DAMP}: loss {loss_k:.6g} vs {loss_p:.6g} (rel "
              f"{rel:.3e}), gradient cosine {cos:.6f} (plain step vs itself "
              f"with one pixel nudged: {yardstick:.6f}), norm ratio "
              f"{ratio:.5f} over {g_k.numel()} values")
        if not (rel <= 1e-2 and cos > 0.9 and cos >= yardstick - 0.02
                and 0.98 < ratio < 1.02 and torch.isfinite(g_k).all().item()):
            fail(f"the {self.label} train step on the kernels disagrees "
                 "with the step on their plain versions (damped weights)")

    def damped(self):
        """The seeded weights with every NB1D block's bn2 scale times
        BN2_DAMP."""
        return {k: v * BN2_DAMP if k.endswith("bn2.weight") else v
                for k, v in self.sd0.items()}

    def hold_f32(self):
        """Phase 4d in float32: the step on the kernels against the step on
        their plain versions, on the seeded weights as drawn (beside the
        kernel step's own rerun) and with the residual branches damped
        (see the docstring for the bars)."""
        loss_k, g_k, loss_p, g_p = self.kernels_vs_plain()
        _, g_r, _ = self.one_step(self.fresh_step(), None)
        for weights, (cos_min, ratio_tol) in (("seeded", F32_AS_DRAWN),
                                              ("damped", F32_DAMPED)):
            if weights == "damped":
                loss_k, g_k, loss_p, g_p = self.kernels_vs_plain(
                    self.damped())
            gk, gp = whole(g_k), whole(g_p)
            rel = abs(loss_k - loss_p) / abs(loss_p)
            cos, ratio = cosine(gk, gp), (gk.norm() / gp.norm()).item()
            rerun = (f"; the kernel step against its own rerun, whose f32 "
                     f"atomics add in another order: "
                     f"{cosine(gk, whole(g_r)):.8f}"
                     if weights == "seeded" else "")
            print(f"train step ({self.label}), kernels vs plain versions, "
                  f"{weights} weights: loss {loss_k:.8g} vs {loss_p:.8g} "
                  f"(rel {rel:.3e}, tol {F32_LOSS:g}), whole gradient cosine "
                  f"{cos:.8f} (least {cos_min}{rerun}), norm ratio "
                  f"{ratio:.6f} (within {ratio_tol:g} of 1) over "
                  f"{gk.numel()} values")
            if not (rel <= F32_LOSS and cos >= cos_min
                    and abs(ratio - 1) <= ratio_tol
                    and torch.isfinite(gk).all().item()):
                fail(f"the {self.label} train step on the kernels disagrees "
                     f"with the step on their plain versions ({weights} "
                     "weights)")

    def eval_step(self, path):
        """One eval step on the kernels with its launches counted."""
        from lanedetection_end2end_tpu_torch.train.steps import (
            make_eval_step)
        wrappers = train_wrappers()
        self.model.load_state_dict(self.sd0)
        reset_counts(wrappers)
        metrics, outputs = make_eval_step(
            self.model, self.cfg, fused_blocks=self.fused_blocks)(self.batch)
        torch.cuda.synchronize()
        if read_counts(wrappers) != PER_EVAL[path]:
            fail(f"eval step ({self.label}) launches {read_counts(wrappers)},"
                 f" expected {PER_EVAL[path]}")
        shapes = {k: tuple(v.shape) for k, v in outputs.items()}
        if (shapes != {"beta": (BATCH, 4, self.cfg.order + 1),
                       "x_cal": (BATCH, 4, 56), "line_pred": (BATCH, 4),
                       "horizon_pred": (BATCH, RESIZE)}
                or not all(torch.isfinite(v.float()).all().item()
                           for v in (*outputs.values(), *metrics.values()))):
            fail(f"eval step ({self.label}) outputs {shapes}")
        print(f"eval step ({self.label}): loss {metrics['loss'].item():.6g}, "
              f"outputs finite, launches (forward, backward) "
              + str({n: v for n, v in PER_EVAL[path].items() if v[0]}))

    def counted_steps(self, n_steps, path, gen, fused_maps=None):
        """n_steps from the seeded weights, dropout on, every launch and
        every call of PyTorch's convolutions and pool counted and held to
        the path's numbers -> (step, counts, losses, ms per step)."""
        import torch.nn.functional as F
        wrappers = train_wrappers()
        step = self.fresh_step(fused_maps=fused_maps)
        reset_counts(wrappers)
        losses, step_ms = [], []
        with count_calls(F, tuple(F_CALLS[path])) as f_calls:
            for _ in range(n_steps):
                loss, grads, ms = self.one_step(step, gen)
                step_ms.append(ms)
                losses.append(loss)
                if not (loss == loss and abs(loss) != float("inf")
                        and torch.isfinite(whole(grads)).all().item()):
                    fail(f"non-finite loss or gradient in a train step "
                         f"({self.label}): {loss}")
        counts = read_counts(wrappers)
        print(f"train launches over {n_steps} step(s), {self.label}, "
              f"fused_maps={fused_maps}: (forward, backward) "
              + str({n: v for n, v in counts.items() if v[0]})
              + f"; calls of torch.nn.functional {f_calls}")
        expected = {n: (n_steps * f, n_steps * b)
                    for n, (f, b) in PER_STEP[path].items()}
        if counts != expected:
            fail(f"launches {counts}, expected {expected}")
        if f_calls != {n: n_steps * c for n, c in F_CALLS[path].items()}:
            fail(f"calls of torch.nn.functional {f_calls}, expected "
                 f"{F_CALLS[path]} per step")
        if step.state.step != n_steps:
            fail(f"state counts {step.state.step} steps")
        return step, counts, losses, step_ms

    def report(self, step_ms, losses, extra=""):
        ms = statistics.median(step_ms)
        print(f"train ({self.label}): losses "
              f"{', '.join(f'{v:.6g}' for v in losses)}; {ms:.3f} ms per "
              f"step of {BATCH} (median of {len(step_ms)}: "
              f"{', '.join(f'{t:.3f}' for t in step_ms)}), "
              f"{1e3 * BATCH / ms:.1f} images/s, adam, dropout on{extra}")
        return ms


def profile_again(step, tr, gen, label):
    """`--profile` of a path that took one counted step: one warm step
    timed on the host clock, then two traced."""
    step(tr.batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(tr.batch, gen)
    torch.cuda.synchronize()
    profile_steps(lambda: step(tr.batch, gen),
                  1e3 * (time.perf_counter() - t0), label)


def train_phase(dev, sd0, dtype, profile=False):
    """Phase 4 in `dtype` on the fused blocks. Returns {kernel: (forward,
    backward) launches} of the 3 default steps."""
    tr = Trainer(dev, sd0, dtype, fused_blocks=True)
    if dtype == "bfloat16":
        tr.hold_bf16()  # 4a
    else:
        tr.hold_f32()
    tr.eval_step("fused")
    with torch.no_grad():
        out = tr.model.apply_packed(
            tr.batch["image"].to(dev).float() / 255.0, train=True,
            dtype=getattr(torch, dtype))
    if out.seg_logits is not None or out.weightmaps is not None:
        fail("the default train-mode forward formed the logits plane")

    # 4b. the main path: 3 steps in the default configuration
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    step, counts, losses, step_ms = tr.counted_steps(TRAIN_STEPS, "fused",
                                                     gen)
    moved = sum(int((p.detach() != sd0[k].to(dev)).any().item())
                for k, p in tr.model.named_parameters())
    n_params = sum(1 for _ in tr.model.parameters())
    if moved < n_params - 2:  # the encoder's 1x1 predict head has no gradient
        fail(f"only {moved} of {n_params} parameter tensors moved")
    ms = tr.report(step_ms, losses, f"; {moved} of {n_params} parameter "
                   f"tensors moved")
    if profile:
        profile_steps(lambda: step(tr.batch, gen), ms,
                      f"{dtype} fused_maps=True")

    # 4c. one step with fused_maps=False: the cuDNN stride-2 blocks with
    # channel_sums, and the elementwise tail over the logits
    step0, _, losses0, step0_ms = tr.counted_steps(1, "maps off", gen,
                                                   fused_maps=False)
    print(f"train ({tr.label}), fused_maps=False: loss {losses0[0]:.6g}, "
          f"{step0_ms[0]:.3f} ms for the one step (its first: no warm-up)")
    if profile:
        profile_again(step0, tr, gen, f"{dtype} fused_maps=False")
    return counts


def unfused_phase(dev, sd0, profile=False):
    """Phase 4d: the unfused path (`fused_blocks=False`) in bf16 and in
    float32, then one step of each with `fused_maps=True`. Returns {dtype:
    {kernel: (forward, backward) launches}} of the 3 counted steps of
    each."""
    launches = {}
    for dtype in ("bfloat16", "float32"):
        tr = Trainer(dev, sd0, dtype, fused_blocks=False)
        if dtype == "bfloat16":
            tr.hold_bf16()
        else:
            tr.hold_f32()
        tr.eval_step("unfused")
        gen = torch.Generator(device=dev).manual_seed(SEED + 5)
        step, counts, losses, step_ms = tr.counted_steps(TRAIN_STEPS,
                                                         "unfused", gen)
        ms = tr.report(step_ms, losses)
        if profile:
            profile_steps(lambda: step(tr.batch, gen), ms,
                          f"unfused {dtype}")
        launches[dtype] = counts
        # the fourth cell: K11 for the NB1D blocks, K8-K10 for the
        # stride-2 blocks and the tail
        step1, _, losses1, step1_ms = tr.counted_steps(
            1, "unfused maps on", gen, fused_maps=True)
        print(f"train ({tr.label}), fused_maps=True: loss "
              f"{losses1[0]:.6g}, {step1_ms[0]:.3f} ms for the one step (its "
              f"first: no warm-up)")
        if profile:
            profile_again(step1, tr, gen, f"unfused {dtype} fused_maps=True")
    return launches


OWN_KERNELS = (  # device functions of csrc/, as the profiler names them
    "conv3tap_kernel", "wgrad3tap_kernel", "dyv_kernel",
    "channel_sums_kernel", "ds_dx_kernel", "lm_fwd_kernel",
    "l2s_kernel", "wgrad_s2_kernel", "dyv_fold_kernel", "hr_bwd_kernel",
    "hr_sum_kernel", "head_rowsums_kernel", "downsampler_kernel",
    "upsampler_kernel",
    "nb1d_chain_kernel", "wls_partial_kernel", "wls_sum_kernel",
    "conv3tap_f32_kernel", "wgrad3tap_f32_kernel", "dz_kernel",
    "wgrad_s2_f32_kernel", "encoder_fused_kernel", "decoder_fused_kernel",
    "s2_gemm_kernel", "s2_wgrad_kernel", "ds1_fwd_kernel", "ds1_wgrad_kernel")
# the stride-2 ops' device kernels, by the op tag in their template
# arguments (csrc/conv_s2.cuh: op_k8, op_k9, and the epilogues op_k8_fwd,
# ...) or by a name only one op launches (K10: its forward, the pass of its
# backward and the fixed-order sum)
STRIDE2_OPS = {"K8": ("op_k8", "ds_dx_kernel", "ds1_"),
               "K9": ("op_k9", "lm_fwd_kernel"),
               "K10": ("hr_bwd_kernel", "hr_sum_kernel",
                       "head_rowsums_kernel")}


def profile_steps(run_step, step_ms: float, label: str,
                  steps: int = 2) -> None:
    """`--profile`: trace `steps` more train steps (or engine calls) with
    torch.profiler and print, after `label`, the card's busy time per step,
    its idle share of the untraced step time `step_ms`, the number of
    device kernels per step, and the kernels that took most of the card's
    time."""
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
    ops = {op: sum(e.self_device_time_total for e in rows
                   if any(t in e.key for t in tags)) / 1e3 / steps
           for op, tags in STRIDE2_OPS.items()}
    if any(ops.values()):
        print(f"profile {label}: stride-2 ops "
              + ", ".join(f"{op} {v:.3f}" for op, v in ops.items())
              + " ms per step")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:16]:
        print(f"profile {label}:   "
              f"{e.self_device_time_total / 1e3 / steps:8.3f} ms "
              f"x{e.count / steps:6.0f}  {e.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if "--race-child" in sys.argv[1:]:
        return race_child()
    from lanedetection_end2end_tpu_torch.config import train_sh_config
    from lanedetection_end2end_tpu_torch.models.infer_engine import (
        FusedLaneNetEngine)
    from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
    from lanedetection_end2end_tpu_torch.ops import _build
    from lanedetection_end2end_tpu_torch.ops.activations import ACTIVATIONS
    from lanedetection_end2end_tpu_torch.ops.backbone import (
        downsampler, downsampler_plain, head_rowsums, head_rowsums_plain,
        upsampler, upsampler_plain)
    from lanedetection_end2end_tpu_torch.ops.backbone_fused import (
        decoder_fused_kernel, encoder_fused_kernel)
    from lanedetection_end2end_tpu_torch.ops.nb1d import (
        nb1d, nb1d_chain, nb1d_plain)
    from lanedetection_end2end_tpu_torch.ops.wls_moments import wls_moments

    # the f32 reference must be f32; the kernels' plain versions read
    # bf16-valued operands, exact in either mode
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_line()
    profile = "--profile" in sys.argv[1:]

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
    # K4 at the activation codes the config does not use: launched once
    # each, not counted in the table's times
    x = act(B, H // 2, W // 2, 16)
    for code, name in enumerate(ACTIVATIONS):
        p = dict(dec["head"], act=code)
        got = head_rowsums(x, p)
        torch.cuda.synchronize()
        want = head_rowsums_plain(x, p)
        err, rel = rel_err(got, want)
        ok = (got.shape == want.shape and torch.isfinite(got).all().item()
              and rel <= TOL_F32)
        print(f"check head_rowsums{tuple(x.shape)} activation {code} "
              f"({name}): max|diff| {err:.3e} ({rel:.2e} of max|plain|, tol "
              f"{TOL_F32:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"head_rowsums activation {name}")
    if failures:
        fail("kernel disagrees with its plain version: "
             + ", ".join(failures))
    # 2b. training kernels against their plain versions, bf16 and float32
    train_summary, failures = {}, []
    for dt, dname in DTYPE_NAMES.items():
        halves, f = check_training_kernels(dev, g, dt)
        lanemaps, f2 = check_lanemap_kernels(dev, g, dt)
        train_summary[dname] = {**halves, **lanemaps}
        failures += f + f2
    failures += check_blocks_through_autograd(dev, g, model.net)
    if failures:
        fail("training kernel disagrees with its plain version: "
             + "; ".join(failures))
    # 2d. K11 and channel_sums in bf16 and float32 ------------------------
    k11_summary, failures = check_k11(dev, g)
    if failures:
        fail("K11 or channel_sums disagrees with its plain version: "
             + "; ".join(failures))

    per_image = {n: s["flop"] / BATCH / 1e9 for n, s in summary.items()}
    print("backbone work per 256x512 image: "
          + ", ".join(f"{n} {g:.3f}" for n, g in per_image.items())
          + f", total {sum(per_image.values()):.3f} GFLOP")

    # 2c. the blocks-mode engine's kernels ------------------------------
    # (one warm-up call of the blocks path with the rolled homography
    # gives the masked maps K12 is held on)
    gi = torch.Generator(device=dev).manual_seed(SEED + 2)
    images = torch.rand(N_BATCHES, BATCH, H, W, 3, generator=gi, device=dev)
    config_fitter = engine.fitter
    roll = Recording(roll_fitter(dev))
    engine._run(packed, images[0], blocks=True)  # cuDNN plans
    engine.fitter = roll
    engine._run(packed, images[0], blocks=True)
    engine.fitter = config_fitter
    torch.cuda.synchronize()
    blocks_summary, failures = check_blocks_kernels(
        dev, g, packed, roll.maps, roll.fitter.basis)
    if failures:
        fail("blocks-mode kernel disagrees: " + "; ".join(failures))

    # 3. engine run -----------------------------------------------------
    engine(packed, images[0])  # warm-up (cuDNN plans of the bf16 heads)
    torch.cuda.synchronize()
    wrappers = {"nb1d": nb1d, "downsampler": downsampler,
                "upsampler": upsampler, "head_rowsums": head_rowsums,
                "encoder_fused": encoder_fused_kernel,
                "decoder_fused": decoder_fused_kernel,
                "nb1d_chain": nb1d_chain, "wls_moments": wls_moments}
    outs, batch_ms, launches = serve(engine, packed, images, wrappers)
    expected = {"nb1d": 0, "downsampler": 0, "upsampler": 0,
                "head_rowsums": 0, "encoder_fused": 1, "decoder_fused": 1,
                "nb1d_chain": 0, "wls_moments": 0}
    print(f"engine launches over {N_BATCHES} calls: {launches}")
    for n, per in expected.items():
        if launches[n] != N_BATCHES * per:
            fail(f"{n}: {launches[n]} launches, expected "
                 f"{N_BATCHES * per}")
    hold_serving(outs, images, model, cfg, "engine")
    ms = statistics.median(batch_ms)
    print(f"engine: {ms:.3f} ms per batch of {BATCH} (median of "
          f"{N_BATCHES}: {', '.join(f'{t:.3f}' for t in batch_ms)}), "
          f"{1e3 * BATCH / ms:.1f} images/s")
    if profile:
        profile_steps(lambda: engine(packed, images[0]), ms, "engine call")

    # 3b. the blocks path: the config's homography (through the private
    # hook, JAX's mode="blocks"), then the rolled one (the public call
    # takes the blocks path by itself, K12 on), each with the counts set
    # to 0 just before
    blocks_launches = {}
    reference_fitter = model.fitter
    on_blocks = lambda p, x: engine._run(p, x, blocks=True)
    for label, fitter, ref_fitter, call, per_call in (
            ("blocks engine", config_fitter, reference_fitter, on_blocks, 0),
            (f"blocks engine, homography rolled {ROLL_DEGREES:g} degrees",
             roll.fitter, PlainFit(roll.fitter), engine, 1)):
        engine.fitter, model.fitter = fitter, ref_fitter
        outs, b_ms, counts = serve(call, packed, images, wrappers)
        print(f"{label}: launches over {N_BATCHES} calls: {counts}")
        want = {"nb1d": 0, "downsampler": 0, "upsampler": 0,
                "head_rowsums": 0, "encoder_fused": 0, "decoder_fused": 0,
                "nb1d_chain": 4, "wls_moments": per_call}
        if counts != {n: N_BATCHES * v for n, v in want.items()}:
            fail(f"{label}: launches {counts}, expected {want} per call")
        hold_serving(outs, images, model, cfg, label)
        b_med = statistics.median(b_ms)
        print(f"{label}: {b_med:.3f} ms per batch of {BATCH} (median of "
              f"{N_BATCHES}: {', '.join(f'{t:.3f}' for t in b_ms)}), "
              f"{1e3 * BATCH / b_med:.1f} images/s; full engine in this "
              f"call {ms:.3f} ms, {1e3 * BATCH / ms:.1f} images/s")
        for n in BLOCKS:
            blocks_launches[n] = blocks_launches.get(n, 0) + counts[n]
        if profile:
            profile_steps(lambda: call(packed, images[0]), b_med,
                          f"{label} call")
    engine.fitter, model.fitter = config_fitter, reference_fitter

    # 3c. the whole encoder and decoder against the block path, and the
    # row-12 harness
    fused_summary, block_launches, library, failures = check_fused_backbone(
        dev, g, model.state_dict(), packed, images)
    for n, v in library.items():
        summary[n].update(library_ms=v, library_of=(
            "cuDNN's product alone at each serving shape, bf16 "
            "channels_last: " + ("F.conv2d 3x3/s2/p1 (no pool, BatchNorm or "
                                 "relu)" if n == "downsampler" else
                                 "F.conv_transpose2d 3x3/s2/p1/op1 (no "
                                 "BatchNorm or relu)")))
    row12_summary, row12_launches, f = check_row12(dev)
    if failures + f:
        fail("fused backbone or row-12 harness: " + "; ".join(failures + f))

    # 3d. images wider than the row tiles, both engine paths ------------
    wide_summary, failures = check_wide(dev)
    if failures:
        fail("wide phase: " + "; ".join(failures))

    # 4. train steps on the fused blocks, bf16 then float32 -------------
    sd0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    fused_launches = {dtype: train_phase(dev, sd0, dtype, profile=profile)
                      for dtype in DTYPE_NAMES.values()}
    # 4d. the unfused path in bf16 and float32
    unfused_launches = unfused_phase(dev, sd0, profile=profile)
    # each kernel's launches from the main path's counted steps of its
    # dtype: the default steps for K6-K10, the unfused ones for K11 and
    # channel_sums
    train_launches = {dtype: dict(fused_launches[dtype]) for dtype in
                      fused_launches}
    for dtype, counts in train_launches.items():
        for n in k11_summary:
            counts[n] = unfused_launches[dtype][n]

    # 4e. the race check of the row tile under compute-sanitizer --------
    race_report, failures = race_check()
    if failures:
        fail("race check: " + "; ".join(failures))

    # 5. kernels line and result ----------------------------------------
    kernels = []
    path_launches = dict(block_launches)
    path_launches.update({n: launches[n] for n in FUSED})
    path_launches.update(blocks_launches, row12=row12_launches)
    path_launches.update({n: v[0]
                          for n, v in train_launches["bfloat16"].items()})

    def numbers(s):
        out = {"max_abs_err": s["max_abs_err"], "ms": s["ms"],
               "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
               "bound_by": ("operations" if 2 * s.get("ops_ms", 0.0)
                            > s["bound_ms"] else "bytes"),
               "library_ms": s.get("library_ms")}
        if "ffma_bound_ms" in s:
            out["ffma_bound_ms"] = s["ffma_bound_ms"]
        return out

    def bwd_numbers(s):
        out = {"bwd_ms": s["bwd_ms"], "plain_bwd_ms": s["plain_bwd_ms"],
               "bwd_bound_ms": s["bwd_bound_ms"],
               "max_rel_err_reduce": s["max_rel_err_reduce"]}
        for key in ("bwd_library_ms", "bwd_ffma_bound_ms"):
            if key in s:
                out[key] = s[key]
        return out

    # the training kernels: the bf16 numbers in the entry, the float32 ones
    # (and launches of the float32 steps) beside them
    by_dtype = {dname: {**train_summary[dname],
                        **{n: v[dname] for n, v in k11_summary.items()}}
                for dname in DTYPE_NAMES.values()}
    for n, s in {**summary, **fused_summary, **blocks_summary,
                 "row12": row12_summary, **by_dtype["bfloat16"]}.items():
        fwd_source, bwd_source = SOURCES.get(n, (f"{n}.cu", None))
        entry = {"name": n, "route": "cuda", "source": CSRC + fwd_source,
                 "replaces": REPLACES[n], "launches": path_launches[n],
                 **numbers(s)}
        if bwd_source is not None:
            entry.update(bwd_source=CSRC + bwd_source,
                         bwd_launches=train_launches["bfloat16"][n][1],
                         **bwd_numbers(s))
        if n in by_dtype["float32"]:
            f = by_dtype["float32"][n]
            f32 = train_launches["float32"][n]
            entry["float32"] = {"launches": f32[0], **numbers(f)}
            if bwd_source is not None:
                entry["float32"].update(bwd_launches=f32[1],
                                        **bwd_numbers(f))
            entry["float32"].update({k: f[k] for k in LIBRARY_NOTES
                                     if k in f})
        if "k1_ms" in s:
            entry["k1_block_by_block_ms"] = s["k1_ms"]
        if "blocks_ms" in s:
            entry["block_sequence_ms"] = s["blocks_ms"]
        if "block_img_per_s" in s:
            entry["block_img_per_s"] = s["block_img_per_s"]
        for key in ("occupancy", "stage_ms"):
            if key in s:
                entry[key] = s[key]
        entry.update({k: s[k] for k in LIBRARY_NOTES if k in s})
        kernels.append(entry)
    print(card)
    print(json.dumps({"kernels": kernels, "wide": wide_summary,
                      "race_check": race_report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
