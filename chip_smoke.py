#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --defer-only

`--profile` also traces two more calls of each engine (full, blocks, blocks
with the rolled homography) and two more train steps of each of the four
training configurations ({`fused_blocks`} x {`fused_maps`}) in bf16 and in
float32 with torch.profiler and prints the card's busy time per call or
step and its largest kernels. Needs one CUDA card, nvcc and the repository
checkout; exits non-zero on any failed check and prints no result without
a card. In order:

1. build the fifteen kernel libraries from
   `lanedetection_end2end_tpu_torch/csrc/`, and the seven of phase 4f in
   the deferred-copy variant (one nvcc per source, all at once), and
   print the card's name and power limit;
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
2e. the kernels that take the lane count, at two lanes (the BEV egolane
   config `bev_defaults(resize=256)`: normalized column coordinate and
   its mask rows), in bf16 and float32: K9's 2x2 head at cout 2 (f32
   out, no moments) and `head_rowsums_op` (K10, bit for bit a second
   launch), forward and backward, against their plain versions; then
   `decoder_fused` at C = 2 on a BEV model's seeded weights, bit for bit
   its block sequence (K4 at C = 2) and against its plain version at
   TOL_S beside the control; each timed beside its plain version;
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
3e. the BEV profile's engine (phase 3's batches, `bev_defaults`, 2
   lanes, order 2, seeded weights): 1 `encoder_fused` + 1
   `decoder_fused` a call and nothing else, beta held to the f32 LaneNet
   at the JAX bar; the same 3 batches through the 4-lane config with
   the heads, its (B, 3, 4) line logits and the horizon logits at 1e-2
   (see below); ms per call (median of 3) beside the BP engine's;
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
4f. the deferred-copy check: one `encoder_fused`, one `decoder_fused`
   and one `nb1d_chain` call at resize 64, and the float32 training
   kernels whose tiles issue cp.async, forward and backward, at the
   256x512 train step's shapes, batch 8 (`nb_half_a` / `nb_half_b` at
   C = 16, 64, 128; `downsampler_op` 16 -> 64, 64 -> 128; `lane_maps_op`
   128 -> 64, 64 -> 16), on the normal build and on `ops/_build.py`'s
   "defer" build (-DLD_DEFER_CP_ASYNC, built beside the normal libraries
   in step 1), where a cp.async copy lands only at its group's wait and
   its destination holds NaN until then, so a read of a ring stage before
   its wait shows every time: the outputs must be finite and equal the
   normal build's bit for bit (the sums of f32 atomics at TOL_REDUCE).
   `--defer-only` builds those seven libraries in both builds and runs
   this phase alone;
4g. the training entry point: `main_torch.main` on the train.sh flags
   (float32, full width and depth) at 256x512, batch 8, on a 32-image
   synthetic dataset (24 training images, 3 steps an epoch; 8 for
   validation; 4 test images): 2 epochs, a resume to 3, `--test_only`,
   `--evaluate`, each with the kernels' launch counts set to 0 just
   before and read just after (per train step 17 + 17 of each half and
   3 + 3 / 2 + 2 / 1 + 1 of K8-K10, per eval step their forwards only,
   none from `test_model`'s `LaneNet.forward`); every epoch's losses
   finite; the resumed run starting at epoch 3 with the checkpoint's
   weights bit for bit; `--test_only` reproducing the best epoch's
   recorded test accuracy; `--evaluate` on the card against the same
   with `--no_cuda true` (the plain versions on the CPU): validation loss
   and every fitted beta at TOL_F32, test accuracy within ACC_TOL; one
   `test_model` through the serving engine (1 + 1 fused launches a batch)
   against `LaneNet.forward` (accuracy within ACC_TOL, beta and logits at
   ENGINE_BARS_TRAINED); the time of each run, ms and images/s a training
   batch per epoch (the mean of its 3 batches) and `test_model`'s ms per
   batch on both paths (warm: the median of TEST_MODEL_CALLS calls after
   the counted one), each beside the card;
4h. the BEV e2e step (`bev_defaults(resize=256, nclasses=2)`, float32,
   adam, phase 4's seeds): a kernel step against a plain step at phase
   4's float32 bars, the cosine as drawn against the same run's noise
   floor (see below), an eval step (K9's head at cout 2, forwards only),
   3 counted steps (17 + 17 of each half, 3 + 3 / 2 + 2 / 1 + 1 of K8-K10,
   K10 at C = 2), finite loss and exact area;
4i. `main_torch.main` through the staged schedule (train.sh flags with
   `--pretrained true --pretrain_epochs 2 --skip_epochs 1`, one epoch a
   call: 0 launches in the skip and seg epochs, 4g's in the e2e one, each
   resume bit for bit) and with `--profile bev` (4 lanes, heads; 2
   epochs, then `--evaluate` on the card against the CPU, beta also
   against a float64 witness beside a bf16 control), every launch
   counted (`staged_phase`);
4j. the learned homography (`train_sh_config(resize=256, reg_ls=1.0,
   learn_homography=True)`, float32, seeded weights): the eval forward
   on the card against the CPU (offsets, M, M_inv, beta, logits), M,
   M_inv and beta also against a float64 witness beside a TF32 and a
   bf16 control; a train step card against CPU (the loss, the whole
   gradient's and the homography head's cosine against the card step's
   own rerun, and damped), 3 steps with dropout on; `main_torch.main
   --learn_homography true` on 4g's flags (2 epochs, a resume,
   `--test_only` through `compute_coordinates_with_M`, `--evaluate` card
   against CPU) and one epoch with `--packed_train false`; no launch of
   any kernel wrapper in the whole phase (`homography_phase`);
5. print the card line as nvidia-smi gives it, the kernels line (with
   the wide phase's, the race check's, the deferred-copy check's, the
   Trainer's, the BEV phases' and the learned homography's results
   beside the kernels; the C = 2
   holdings as each kernel's `two_lanes`), and `{"ok": true, "device":
   {...}}` last.

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
`channel_sums`). `lane_maps_op`, `head_rowsums_op` and `decoder_fused`
carry phase 2e's numbers at two lanes in a `two_lanes` object (per
dtype, K9 the head's shape only), with the launches of the BEV paths:
the 3 engine calls of phase 3e, the 3 counted steps of phase 4h. The
training
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

The engine's heads run in bf16 on the bf16 encoder features, as in the
JAX package's engine. On phase 3e's 4-lane weights their horizon logits
miss the JAX bar (rtol = atol = 1e-2) against the f32 LaneNet on one of
the 3 batches (max|diff| 1.324e-2), and so does the same engine on the
fused kernels' plain versions (1.313e-2; measured on an H100). So the
rounding is the design's, not the kernels': on a batch where the plain
versions miss the bar too, phase 3e holds the kernels' logits against
the plain versions' at the same bar (they differ there by one bf16 step
of the output, 7.8e-3).

The BEV float32 step (phase 4h: 2 lanes, area loss on normalized
coordinates) amplifies it more: measured on an H100, on its first seeds
the kernel step against the plain step read 0.99455 beside its own rerun
at 0.99663, so 0.995 sits at its noise floor. So the cosine as drawn is
held against that floor as the same run measures it: no more than
BEV_NOISE_MARGIN = 5e-3 below the kernel step against its own rerun (it
read 0.9e-3 to 2.1e-3 below it in five runs). The damped bar, 0.99999
(read 0.9999944-0.9999959), is the sharp one.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
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
# phase 4h (BEV): the least whole-gradient cosine as drawn is the kernel
# step against its own rerun in the same run, less this margin
BEV_NOISE_MARGIN = 5e-3
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
def plain_engine():
    """The serving engine's full path on the fused kernels' plain versions
    (`encoder_plain` / `decoder_plain`: the block sequence in PyTorch,
    bf16 as the kernels), for a comparison on the card."""
    from lanedetection_end2end_tpu_torch.models import infer_engine as ie
    from lanedetection_end2end_tpu_torch.ops.backbone_fused import (
        decoder_plain, encoder_plain)
    kernels = ie.encoder_fused, ie.decoder_fused
    ie.encoder_fused = lambda images, p: encoder_plain(
        images.to(torch.bfloat16).contiguous(), p)
    ie.decoder_fused = decoder_plain
    try:
        yield
    finally:
        ie.encoder_fused, ie.decoder_fused = kernels


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
# Phase 2e: the head kernels at two lanes (the BEV egolane config)
# ----------------------------------------------------------------------

TWO_LANE_KERNELS = ("lane_maps_op", "head_rowsums_op", "decoder_fused")


def check_two_lanes(dev, g):
    """Phase 2e. The kernels that take the lane count, at C = 2 and the
    256x512 batch-8 shapes of `bev_defaults(resize=256)` (normalized
    column coordinate, its mask rows): in bf16 and float32, K9's 2x2 head
    at cout 2 (f32 out, no moments, as the eval step runs it) forward and
    backward, and `head_rowsums_op` (K10) forward and backward, bit for bit
    a second launch; then `decoder_fused` on a BEV model's seeded weights,
    bit for bit its block sequence (`decoder_blocks`, K4 at C = 2) and
    against its plain version at TOL_S beside the control. Each timed
    beside its plain version. Returns ({kernel: {dtype: summary}},
    failures)."""
    from lanedetection_end2end_tpu_torch.config import bev_defaults
    from lanedetection_end2end_tpu_torch.models.fused_graph import (
        decoder_blocks, encoder_blocks)
    from lanedetection_end2end_tpu_torch.models.infer_engine import (
        FusedLaneNetEngine)
    from lanedetection_end2end_tpu_torch.models.lanenet import (
        LaneNet, make_fitter, zero_rows)
    from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
    from lanedetection_end2end_tpu_torch.ops.backbone_fused import (
        decoder_fused_kernel, decoder_plain)

    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    cfg = bev_defaults(resize=RESIZE)
    C = cfg.out_channels
    xs = make_fitter(cfg, dev).sep_xs
    zero = zero_rows(cfg)
    B, H, W = BATCH, RESIZE, 2 * RESIZE
    out = {n: {} for n in TWO_LANE_KERNELS}
    failures = []
    for dt, dname in DTYPE_NAMES.items():
        es = torch.finfo(dt).bits // 8
        pt = plane_tols(dt)
        x = rn(B, H // 2, W // 2, 16).to(dt)
        wt, bias = rn(16, C, 2, 2) / 4.0, 0.1 * rn(C)

        # K9's head at cout 2: f32 logits, no moments
        s = dict.fromkeys(TRAIN_KEYS, 0.0)
        dy = rn(B, H, W, C)
        op = lambda: lm.lane_maps_op(x, wt, bias, 2, torch.float32, False)
        plain = lambda: lm.lane_maps_fwd_plain(x, wt, bias, 2, torch.float32,
                                               False)
        with torch.no_grad():
            y, mom = op()
            torch.cuda.synchronize()
            py, _ = plain()
            args = (x, None, dy, None, wt, 2)
            grads = lm.lane_maps_bwd_kernel(*args)
            torch.cuda.synchronize()
            pgrads = lm.lane_maps_bwd_plain(*args)
        label = (f"lane_maps_op {dname} {tuple(x.shape)}->{C} k=2 float32 "
                 "out no moments, two lanes")
        verdict = hold(label, [
            ("y", y, py, *pt), ("dx", grads[0], pgrads[0], *pt),
            ("dweight", grads[1], pgrads[1], *pt),
            ("dbias", grads[2], pgrads[2])], s, failures)
        if mom is not None:
            failures.append(f"{label}: moments returned")
        planes = (es * x.numel() + 4 * y.numel(),
                  2 * es * x.numel() + 4 * y.numel())
        rate = BF16_FLOP_PER_S if dt == torch.bfloat16 else FP32_FLOP_PER_S
        time_and_record(
            label, s, 1, verdict, op, plain,
            lambda: lm.lane_maps_bwd_kernel(*args),
            lambda: lm.lane_maps_bwd_plain(*args),
            lambda bwd: s2_work((B, H // 2, W // 2), 16, C, 2, planes, bwd,
                                es), rate)
        out["lane_maps_op"][dname] = s

        # K10 at C = 2
        s = dict.fromkeys(TRAIN_KEYS, 0.0)
        dS = rn(B, H, 2 * C)
        with torch.no_grad():
            S = lm.head_rowsums_op(x, wt, bias, xs, zero)
            torch.cuda.synchronize()
            pS = lm.head_rowsums_fwd_plain(x, wt, bias, xs, zero)
            args = (x, dS, wt, bias, xs, zero)
            hgrads = lm.head_rowsums_bwd_kernel(*args)
            torch.cuda.synchronize()
            phgrads = lm.head_rowsums_bwd_plain(*args)
            again = lm.head_rowsums_op(x, wt, bias, xs, zero)
            hgrads2 = lm.head_rowsums_bwd_kernel(*args)
        label = f"head_rowsums_op {dname} {tuple(x.shape)}, two lanes"
        sums_tol = (TOL_F32,) if dt == torch.float32 else ()
        verdict = hold(label, [
            ("S", S, pS, TOL_F32), ("dx", hgrads[0], phgrads[0], *pt),
            ("dweight", hgrads[1], phgrads[1], *sums_tol),
            ("dbias", hgrads[2], phgrads[2], *sums_tol)], s, failures)
        same = torch.equal(S, again) and all(
            torch.equal(a, b) for a, b in zip(hgrads, hgrads2))
        if not same or S[:, :zero].abs().max().item() != 0.0:
            failures.append(f"{label}: a second launch differs or the "
                            "masked rows are not zero")
        logits = B * (H - zero) * W * C

        def head_op_work(bwd):
            flop = logits * ((2 * 16 + 5) if not bwd else (3 * 2 * 16 + 8))
            nbytes = es * x.numel() + 4 * S.numel() + 4 * wt.numel()
            return flop, nbytes + bwd * es * x.numel()
        time_and_record(
            label + f" (a second launch bit for bit: {same})", s, 1,
            verdict, lambda: lm.head_rowsums_op(x, wt, bias, xs, zero),
            lambda: lm.head_rowsums_fwd_plain(x, wt, bias, xs, zero),
            lambda: lm.head_rowsums_bwd_kernel(*args),
            lambda: lm.head_rowsums_bwd_plain(*args), head_op_work,
            rate)
        out["head_rowsums_op"][dname] = s

    # decoder_fused at C = 2 on a BEV model's seeded weights
    model = LaneNet(cfg, device=dev)
    model.load_state_dict(random_state_dict(model, SEED + 7))
    packed = FusedLaneNetEngine(cfg, device=dev).prepare(model.state_dict())
    dec = packed["dec"]
    head = dec["head"]
    up = 1 + 2 ** -8
    dec_c = dict(dec, head=dict(head, w=head["w"].float() * up,
                                bias=head["bias"] * up))
    images = torch.rand(B, H, W, 3, generator=g, device=dev)
    enc = encoder_blocks(images, packed["enc"])
    with torch.no_grad():
        S_k = decoder_fused_kernel(enc, dec)
        torch.cuda.synchronize()
        S_b = decoder_blocks(enc, dec)
        S_p = decoder_plain(enc, dec)
        control = rel_err(decoder_plain(enc, dec_c), S_p)[1]
    err, rel = rel_err(S_k, S_p)
    same = torch.equal(S_k, S_b)
    ok = (same and tuple(S_k.shape) == (B, H, 2 * C)
          and torch.isfinite(S_k).all().item() and rel <= TOL_S
          and control > TOL_S)
    k_ms, b_ms, p_ms = (median_ms(f) for f in (
        lambda: decoder_fused_kernel(enc, dec),
        lambda: decoder_blocks(enc, dec), lambda: decoder_plain(enc, dec)))
    bnd, by = bound_ms(*decoder_work(dec, B, H, W))
    print(f"check decoder_fused {B}x{H}x{W}, two lanes: bit for bit equal "
          f"to the block sequence: {same}; max|diff| vs plain {err:.3e} "
          f"({rel:.2e} of max|plain|, tol {TOL_S:g}); control, logits x "
          f"(1 + 2^-8): {control:.2e} of max|plain|, "
          f"{'' if control > TOL_S else 'NOT '}above the tol: "
          f"{'ok' if ok else 'FAIL'}; fused {k_ms:.4f} ms, block sequence "
          f"{b_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bnd:.4f} ms ({by})")
    if not ok:
        failures.append("decoder_fused at two lanes")
    out["decoder_fused"]["bfloat16"] = {
        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd,
        "ops_ms": bnd * (by == "operations"), "blocks_ms": b_ms}
    return out, failures


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


def logit_excess(a, b):
    """The largest excess of |a - b| over the JAX bar, rtol = atol = 1e-2
    of b (> 0: a misses it)."""
    return ((a - b).abs() - (1e-2 + 1e-2 * b.abs())).max().item()


def hold_serving(outs, images, model, cfg, label, plain=None):
    """Hold an engine's outputs against the plain float32 LaneNet `model`
    at the JAX package's bars; returns the worst errors. Without `clas`
    the engine must return no logits; the BEV line logits are (B, 3,
    4). `plain`: the same engine's outputs on the fused kernels' plain
    versions (phase 3e); on a batch where they miss the logit bar against
    the f32 LaneNet too, the kernels' logits are held against theirs at
    that bar instead."""
    worst = {"beta": 0.0, "line": 0.0, "horizon": 0.0}
    if plain is not None:
        worst.update(line_plain=0.0, horizon_plain=0.0, held_to_plain=[])
    C = cfg.out_channels
    line_shape = (3, 4) if cfg.profile == "bev" else (4,)
    for i, ((beta, line, hor), x) in enumerate(zip(outs, images)):
        ref = model(x)
        n, h = x.shape[:2]
        heads = (("line", line, ref.line_logits, (n, *line_shape)),
                 ("horizon", hor, ref.horizon_logits, (n, h)))
        if (tuple(beta.shape) != (n, C, cfg.order + 1)
                or any((a is None) != (not cfg.clas) for _, a, _, _ in heads)
                or (cfg.clas and any(tuple(a.shape) != shape
                                     for _, a, _, shape in heads))):
            fail(f"{label}: output shapes {beta.shape} "
                 f"{getattr(line, 'shape', None)} {getattr(hor, 'shape', None)}")
        for t in (beta, line, hor):
            if t is not None and not torch.isfinite(t).all():
                fail(f"{label}: non-finite engine output")
        rel = ((beta - ref.beta).abs().max()
               / ref.beta.abs().max()).item()
        worst["beta"] = max(worst["beta"], rel)
        for key, a, b, _ in heads if cfg.clas else ():
            excess = logit_excess(a, b)
            worst[key] = max(worst[key], (a - b).abs().max().item())
            if plain is not None:
                p = plain[i][1 if key == "line" else 2]
                worst[f"{key}_plain"] = max(worst[f"{key}_plain"],
                                            (p - b).abs().max().item())
                if excess > 0 and logit_excess(p, b) > 0:
                    print(f"{label}: batch {i} {key} logits miss the bar "
                          f"against the f32 LaneNet on the plain versions "
                          f"too ({(p - b).abs().max().item():.3e}; the "
                          f"kernels {(a - b).abs().max().item():.3e}): the "
                          "kernels held against the plain versions, max|diff|"
                          f" {(a - p).abs().max().item():.3e}")
                    worst["held_to_plain"].append(f"{i} {key}")
                    excess = logit_excess(a, p)
            if excess > 0:
                fail(f"{label}: {key} logits off the f32 LaneNet by "
                     f"{(a - b).abs().max().item():.3e}")
        if rel >= 3e-2:
            fail(f"{label}: beta relative error {rel:.3e} >= 3e-2")
    print(f"{label} vs f32 LaneNet: beta max rel {worst['beta']:.3e}"
          + (f", line max|diff| {worst['line']:.3e}, horizon max|diff| "
             f"{worst['horizon']:.3e}" if cfg.clas else ", no heads")
          + (f" (on the plain versions: line {worst['line_plain']:.3e}, "
             f"horizon {worst['horizon_plain']:.3e})"
             if plain is not None and cfg.clas else ""))
    return worst


def serve_bev(dev, images, wrappers, bp_ms):
    """Phase 3e. The BEV egolane config `bev_defaults(resize=256)` (2
    lanes, order 2, area loss, normalized homography; seeded random
    weights with non-trivial BatchNorm statistics) through
    `FusedLaneNetEngine` on the 3 batches of 8, the launch counts set to 0
    just before and read just after (1 `encoder_fused` + 1 `decoder_fused`
    a call, 0 of the rest), beta held to the float32 LaneNet at the JAX
    bar; then the same 3 batches through `bev_defaults(nclasses=4,
    clas=True)`, its (B, 3, 4) line logits and horizon logits held at
    1e-2 (on a batch where the engine on the fused kernels' plain
    versions misses that bar against the f32 LaneNet too, the kernels'
    logits are held against the plain versions' at that bar); each timed
    as the median of its 3 calls. Any failure exits. Returns the
    summary."""
    from lanedetection_end2end_tpu_torch.config import bev_defaults
    from lanedetection_end2end_tpu_torch.models.infer_engine import (
        FusedLaneNetEngine)
    from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet

    summary = {}
    for label, cfg, batches in (
            ("BEV engine, 2 lanes", bev_defaults(resize=RESIZE), images),
            ("BEV engine, 4 lanes and heads",
             bev_defaults(resize=RESIZE, nclasses=4, clas=True),
             images)):
        model = LaneNet(cfg, device=dev)
        model.load_state_dict(random_state_dict(model, SEED + 8))
        engine = FusedLaneNetEngine(cfg, device=dev)
        packed = engine.prepare(model.state_dict())
        engine(packed, batches[0])  # warm-up (cuDNN plans of the heads)
        torch.cuda.synchronize()
        outs, batch_ms, launches = serve(engine, packed, batches, wrappers)
        want = dict.fromkeys(wrappers, 0)
        want.update(encoder_fused=len(batches), decoder_fused=len(batches))
        print(f"{label}: launches over {len(batches)} calls: {launches}")
        if launches != want:
            fail(f"{label}: launches {launches}, expected {want}")
        with plain_engine():
            plain = [engine(packed, x) for x in batches]
        worst = hold_serving(outs, batches, model, cfg, label, plain)
        ms = statistics.median(batch_ms)
        print(f"{label}: {ms:.3f} ms per batch of {BATCH} (median of "
              f"{len(batch_ms)}: {', '.join(f'{t:.3f}' for t in batch_ms)}),"
              f" {1e3 * BATCH / ms:.1f} images/s; the BP engine in this call "
              f"{bp_ms:.3f} ms")
        summary[label] = {"ms_per_batch": ms, "batch_ms": batch_ms,
                          "bp_engine_ms": bp_ms, "launches": launches,
                          **worst}
    return summary


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


# ----------------------------------------------------------------------
# Deferred-copy check: the cp.async contract made literal
# ----------------------------------------------------------------------

# the libraries the deferred-copy phase builds in `ops/_build.py`'s "defer"
# variant (-DLD_DEFER_CP_ASYNC): every library whose kernels issue cp.async
DEFER_SOURCES = ("encoder_fused", "decoder_fused", "nb1d_chain",
                 "nb_half_fwd", "nb_half_bwd", "downsampler_op",
                 "lane_maps_op")
# outputs summed with f32 atomics, in an order that changes from run to
# run: held at TOL_REDUCE of max|normal|; every other output bit for bit
DEFER_SUMS = ("mom", "dmul", "dadd", "dkh", "dbh", "dkw", "dbw", "dweight",
              "dbias")


def defer_calls(dev):
    """{label: call}: each call returns {output name: tensor}. The serving
    kernels at resize 64 (batch 2, seeded random weights), and the float32
    training kernels of the default train step, forward and backward, at
    its 256x512 shapes, batch 8: `nb_half_a` on the 16-channel plane,
    `nb_half_b` on the 64-channel plane (d = 1) and the 128-channel one
    (d = 16), `downsampler_op` 16 -> 64 and 64 -> 128, `lane_maps_op`
    128 -> 64 and 64 -> 16 (the shapes whose tiles issue cp.async; the
    first downsampler and the head run on FFMA). Every input is made once,
    here; a backward reads the stashes of the plain forward."""
    from lanedetection_end2end_tpu_torch.config import train_sh_config
    from lanedetection_end2end_tpu_torch.models.infer_engine import (
        FusedLaneNetEngine)
    from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
    from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
    from lanedetection_end2end_tpu_torch.ops import nb_block as nb
    from lanedetection_end2end_tpu_torch.ops.backbone_fused import (
        decoder_fused_kernel, encoder_fused_kernel)
    from lanedetection_end2end_tpu_torch.ops.nb1d import nb1d_chain
    cfg = train_sh_config(resize=64, reg_ls=1.0)
    engine = FusedLaneNetEngine(cfg, device=dev)
    packed = engine.prepare(random_state_dict(LaneNet(cfg, device="cpu"),
                                              SEED))
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    x = torch.rand(2, 64, 128, 3, generator=g, device=dev).to(torch.bfloat16)

    def serving():
        enc = encoder_fused_kernel(x, packed["enc"])
        return {"encoder_fused": enc,
                "decoder_fused": decoder_fused_kernel(enc, packed["dec"]),
                "nb1d_chain": nb1d_chain(enc, packed["enc_nb128"])}

    calls = {"serving resize 64": serving}
    B, H, W = BATCH, RESIZE, 2 * RESIZE
    for half, (h, w, C), d in (("a", (H // 2, W // 2, 16), 1),
                               ("b", (H // 4, W // 4, 64), 1),
                               ("b", (H // 8, W // 8, 128), 16)):
        xh = rn(B, h, w, C)
        kh, kw = rn(3, C, C) / (3 * C) ** 0.5, rn(3, C, C) / (3 * C) ** 0.5
        bh, bw = 0.1 * rn(C), 0.1 * rn(C)
        mul = add = None
        if half == "b":
            mul, add = 0.5 + torch.rand(C, generator=g, device=dev), rn(C)
        py, pmid, _ = nb.half_fwd_plain(xh, mul, add, kh, bh, kw, bw, d)
        bwd_args = (xh, mul, add, pmid, py, rn(B, h, w, C), 1e-3 * rn(2, C),
                    kh, kw, d)

        def half_call(half=half, xh=xh, mul=mul, add=add, kh=kh, bh=bh,
                      kw=kw, bw=bw, d=d, bwd_args=bwd_args):
            y, mom = (nb.nb_half_a(xh, kh, bh, kw, bw) if half == "a" else
                      nb.nb_half_b(xh, mul, add, kh, bh, kw, bw, d))
            names = ("dx", "dmul", "dadd", "dkh", "dbh", "dkw", "dbw")
            out = {"y": y, "mom": mom}
            out.update((n, t) for n, t in zip(
                names, nb.half_bwd_kernel(*bwd_args)) if t is not None)
            return out
        calls[f"nb_half_{half} {(B, h, w, C)} d={d}"] = half_call

    for (h, w, cin), cout in (((H // 2, W // 2, 16), 64),
                              ((H // 4, W // 4, 64), 128)):
        cc = cout - cin
        xd = plant_pool_ties(torch.relu(rn(B, h, w, cin)))
        wt, bias = rn(cc, cin, 3, 3) / (9 * cin) ** 0.5, 0.1 * rn(cc)
        args = (xd, lm.downsampler_fwd_plain(xd, wt, bias)[0],
                rn(B, h // 2, w // 2, cout), 1e-3 * rn(2, cout), wt)

        def down_call(xd=xd, wt=wt, bias=bias, args=args):
            y, mom = lm.downsampler_op(xd, wt, bias)
            dx, dw, db = lm.downsampler_bwd_kernel(*args)
            return {"y": y, "mom": mom, "dx": dx, "dweight": dw, "dbias": db}
        calls[f"downsampler_op {(B, h, w, cin)}->{cout}"] = down_call

    for (h, w, cin), cout in (((H // 8, W // 8, 128), 64),
                              ((H // 4, W // 4, 64), 16)):
        xu = rn(B, h, w, cin)
        wt, bias = rn(cin, cout, 3, 3) / (9 * cin / 4) ** 0.5, 0.1 * rn(cout)
        args = (xu, lm.lane_maps_fwd_plain(xu, wt, bias, 3, torch.float32,
                                           True)[0],
                rn(B, 2 * h, 2 * w, cout), 1e-3 * rn(2, cout), wt, 3)

        def up_call(xu=xu, wt=wt, bias=bias, args=args):
            y, mom = lm.lane_maps_op(xu, wt, bias, 3, torch.float32, True)
            dx, dw, db = lm.lane_maps_bwd_kernel(*args)
            return {"y": y, "mom": mom, "dx": dx, "dweight": dw, "dbias": db}
        calls[f"lane_maps_op {(B, h, w, cin)}->{cout}"] = up_call
    return calls


def defer_check(dev):
    """The deferred-copy phase: every call of `defer_calls` on the normal
    build, then the same calls on the "defer" build, in which every
    cp.async copy lands only at its group's wait and its destination holds
    NaN until then (`csrc/tc_common.cuh`). A read of a ring stage before
    its wait so reads NaN every time. Every output must be finite and equal
    the normal build's bit for bit; the outputs summed with f32 atomics
    (DEFER_SUMS), whose order changes from run to run, at TOL_REDUCE of
    max|normal|. Returns ({call: verdict}, failures)."""
    from lanedetection_end2end_tpu_torch.ops import _build
    calls = defer_calls(dev)

    def run():
        with torch.no_grad():
            out = {label: call() for label, call in calls.items()}
        torch.cuda.synchronize()
        return out

    normal = run()
    t0 = time.perf_counter()
    with _build.variant("defer"):
        deferred = run()
    secs = time.perf_counter() - t0
    report, failures, n = {}, [], 0
    for label, outs in normal.items():
        bad = []
        for name, want in outs.items():
            got = deferred[label][name]
            n += 1
            finite = bool(torch.isfinite(got.float()).all().item())
            if name in DEFER_SUMS:
                rel = rel_err(got, want)[1]
                ok = finite and rel <= TOL_REDUCE
                said = f"{rel:.2e} of max|normal| (tol {TOL_REDUCE:g})"
            else:
                ok = finite and torch.equal(got, want)
                said = ("bit for bit" if torch.equal(got, want) else
                        f"differs, max|diff| "
                        f"{(got.float() - want.float()).abs().max().item():.3e}")
            print(f"deferred copies {label} {name}{tuple(got.shape)}: "
                  f"finite {finite}, {said} against the normal build "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"{name}: {said}, finite {finite}")
        report[label] = "ok" if not bad else "FAIL: " + "; ".join(bad)
        failures += [f"{label} {b}" for b in bad]
    print(f"deferred copies: {n} outputs of {len(calls)} calls in "
          f"{secs:.1f} s")
    return report, failures


# ----------------------------------------------------------------------
# Phase 4g: the training entry point, main_torch.py, on the card
# ----------------------------------------------------------------------

# `main_torch.main` on the train.sh flags at 256x512, batch 8, float32 (the
# config's dtype), full ERFNet width and depth, on a 32-image synthetic
# dataset the port writes: 24 training images (3 steps an epoch), 8 for
# validation (1 eval step), 4 for the test set (1 padded batch of 8)
TRAINER_ARGV = (
    "--loss_policy backproject --nclasses 4 --order 3 --clas 1 "
    "--pretrained false --mask_percentage 0.20 --flip_on 1 "
    "--synthetic 32 --split_percentage 0.25 --resize 256 --batch_size 8 "
    "--save_freq 3 --print_freq 1").split()
TRAIN_BATCHES, VAL_BATCHES = 3, 1
TEST_MODEL_CALLS = 10  # warm test_model calls timed after the counted one
ACC_TOL = 0.02  # test accuracy of the card against the CPU
# The bf16 engine against the f32 LaneNet on the Trainer's weights (kaiming
# init, a few steps), max|diff| / max|LaneNet|: beta at the engine's own
# 3e-2; line and horizon logits at 1e-1. The JAX package's 1e-2 logit bar
# holds on its init weights only: on kaiming weights at resize 32 its own
# bf16 engine reads 7.0e-2 (line) and 8.9e-3 (horizon) of max|LaneNet|,
# the port's 6.6e-2 and 1.1e-2 (tests/test_torch_eval.py).
ENGINE_BARS_TRAINED = {"beta": 3e-2, "line": 1e-1, "horizon": 1e-1}


def _main_torch(argv):
    """`main_torch.main(argv)` with the Logger tee it installs removed
    again; -> (its result, seconds)."""
    import main_torch
    stdout = sys.stdout
    t0 = time.perf_counter()
    try:
        out = main_torch.main(argv)
    finally:
        sys.stdout = stdout
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _expected(train_steps: int, eval_steps: int):
    """Launches of `train_steps` default train steps and `eval_steps` eval
    steps."""
    return {n: (train_steps * PER_STEP["fused"][n][0]
                + eval_steps * PER_EVAL["fused"][n][0],
                train_steps * PER_STEP["fused"][n][1])
            for n in TRAIN_OPS}


def trainer_phase(dev, card):
    """Phase 4g, the Trainer on the card through `main_torch.main`: 2
    epochs, a resume to 3, `--test_only`, `--evaluate` (each with the
    kernels' launch counts set to 0 just before and read just after),
    then the same `--evaluate` with `--no_cuda true` on the CPU's plain
    versions, and `test_model` through the serving engine. Holds: the
    launches (per train step K6 / K7 17 + 17 forward and backward, K8-K10
    3 + 3 / 2 + 2 / 1 + 1; per eval step forwards only; none in
    `test_model`'s `LaneNet.forward`), every epoch's losses finite, the
    resumed run starting at epoch 3 with the checkpoint's weights bit for
    bit, `--test_only` reproducing the best epoch's recorded accuracy,
    the card's validation loss and fitted beta against the CPU's at
    TOL_F32 (of the loss, and of max|beta|) and its test accuracy within
    ACC_TOL, and one `test_model(use_engine=True)` against
    `use_engine=False`: accuracy within ACC_TOL, the engine's beta and
    logits on the test images at ENGINE_BARS_TRAINED.
    Returns (summary, failures)."""
    import shutil
    from pathlib import Path

    import main_torch
    from lanedetection_end2end_tpu_torch.data.dataset import LaneTestSet
    from lanedetection_end2end_tpu_torch.data.labels import read_json_lines
    from lanedetection_end2end_tpu_torch.data.loader import get_testloader
    from lanedetection_end2end_tpu_torch.eval import test_driver
    from lanedetection_end2end_tpu_torch.models.infer_engine import (
        FusedLaneNetEngine)
    from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
    from lanedetection_end2end_tpu_torch.ops.backbone_fused import (
        decoder_fused_kernel, encoder_fused_kernel)
    from lanedetection_end2end_tpu_torch.train.checkpoint import (
        best_checkpoint_path)

    root = Path(__file__).resolve().parent / "_smoke" / "trainer"
    shutil.rmtree(root, ignore_errors=True)
    argv = TRAINER_ARGV + ["--save_path", str(root)]
    cfg = main_torch.parse_args(argv)[0]
    run = root / cfg.save_id
    wrappers = train_wrappers()
    serving = {"encoder_fused": encoder_fused_kernel,
               "decoder_fused": decoder_fused_kernel}
    failures, summary = [], {}
    # the dataset main_torch would write, written first so that the runs
    # below time training only
    from lanedetection_end2end_tpu_torch.data.synthetic import (
        make_synthetic_root)
    t0 = time.perf_counter()
    make_synthetic_root(str(root / "synthetic_data"), num_train=32,
                        num_test=4, seed=cfg.seed)
    print(f"trainer: synthetic dataset of 32 + 4 images written in "
          f"{time.perf_counter() - t0:.1f} s")

    def counted(label, extra, train_steps, eval_steps):
        reset_counts(wrappers)
        for w in serving.values():
            w.launches = 0
        out, secs = _main_torch(argv + extra)
        got, want = read_counts(wrappers), _expected(train_steps, eval_steps)
        print(f"trainer {label}: {secs:.1f} s, launches {got}")
        if got != want:
            failures.append(f"{label}: launches {got}, expected {want}")
        if any(w.launches for w in serving.values()):
            failures.append(f"{label}: the serving kernels ran")
        return out, secs

    # 2 epochs, then a resume to 3 -----------------------------------
    with watch_resume() as resumed:
        _, fit_s = counted("fit, 2 epochs", ["--nepochs", "2"],
                           2 * TRAIN_BATCHES, 2 * VAL_BATCHES)
        _, resume_s = counted("resume to 3 epochs", ["--nepochs", "3"],
                              TRAIN_BATCHES, VAL_BATCHES)
    if resumed != {"start": 2, "equal": True}:
        failures.append(f"resume: {resumed}, expected the run to start at "
                        "epoch 3 with the checkpoint's weights bit for bit")
    rows = read_json_lines(str(run / "scalars.jsonl"))
    if [r["epoch"] for r in rows] != [1, 2, 3]:
        failures.append(f"scalars.jsonl epochs {[r['epoch'] for r in rows]}")
    for r in rows:
        losses = {k: r[k] for k in ("train_loss", "val_loss")}
        print(f"trainer epoch {r['epoch']}: {losses}, test_acc "
              f"{r['test_acc']:.6f}, {1e3 * r['train_batch_time']:.1f} ms "
              f"a training batch ({8 / r['train_batch_time']:.1f} images/s;"
              f" the mean of the epoch's {TRAIN_BATCHES} batches, data wait "
              f"included{', the first calls too' if r['epoch'] == 1 else ''}"
              f") on {card}")
        if not all(map(math.isfinite, losses.values())):
            failures.append(f"epoch {r['epoch']}: losses {losses}")
    if not (run / "example" / "train" / "idx-0_batch-3.png").exists():
        failures.append("no weight-map panel at training batch 3")

    # --test_only and --evaluate on the best checkpoint ----------------
    best = best_checkpoint_path(str(run))
    best_epoch = int(best.rsplit("_", 1)[1].split(".")[0])
    recorded = rows[best_epoch]["test_acc"]
    out, test_s = counted("--test_only", ["--nepochs", "3", "--test_only"],
                          0, 0)
    print(f"trainer --test_only: accuracy {out['acc']:.8f}, recorded at "
          f"epoch {best_epoch + 1}: {recorded:.8f}")
    if out["acc"] != recorded:
        failures.append(f"--test_only accuracy {out['acc']} differs from "
                        f"epoch {best_epoch + 1}'s {recorded}")
    card_eval, eval_s = counted("--evaluate", ["--nepochs", "3",
                                               "--evaluate"], 0, VAL_BATCHES)
    card_beta = [r["params"] for r in read_json_lines(
        str(run / "validation_set_dst.json"))]
    cpu_eval, cpu_s = _main_torch(argv + ["--nepochs", "3", "--evaluate",
                                          "--no_cuda", "true"])
    cpu_beta = [r["params"] for r in read_json_lines(
        str(run / "validation_set_dst.json"))]
    loss_rel = abs(card_eval["loss"] - cpu_eval["loss"]) / abs(
        cpu_eval["loss"])
    _, beta_rel = rel_err(torch.tensor(card_beta), torch.tensor(cpu_beta))
    acc_diff = abs(card_eval["test_acc"] - cpu_eval["test_acc"])
    ok = (loss_rel <= TOL_F32 and beta_rel <= TOL_F32
          and acc_diff <= ACC_TOL)
    print(f"trainer --evaluate, card vs CPU ({cpu_s:.1f} s): loss "
          f"{card_eval['loss']:.6f} / {cpu_eval['loss']:.6f} ({loss_rel:.2e}"
          f" relative, tol {TOL_F32:g}), beta {beta_rel:.2e} of max|CPU| "
          f"(tol {TOL_F32:g}), test accuracy {card_eval['test_acc']:.6f} / "
          f"{cpu_eval['test_acc']:.6f} (tol {ACC_TOL}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"--evaluate card vs CPU: loss {loss_rel:.2e}, beta "
                        f"{beta_rel:.2e}, accuracy {acc_diff:.3f}")

    # test_model through the engine, against LaneNet.forward ------------
    cfg = cfg.replace(test_dir=str(root / "synthetic_data" / "test_set"))
    model = LaneNet(cfg, device=dev)
    ckpt = torch.load(best, map_location=dev, weights_only=False)
    model.load_state_dict(ckpt["state_dict"]["model"])
    test_set = LaneTestSet(str(Path(cfg.test_dir) / "test_label.json"),
                           cfg.test_dir, cfg.resize)
    loader = get_testloader(test_set, cfg.batch_size, nworkers=4)
    accs, ms = {}, {}
    for engine in (False, True):
        for w in serving.values():
            w.launches = 0
        reset_counts(wrappers)
        accs[engine] = test_driver.test_model(
            loader, model, cfg, save_path=str(root / f"engine_{engine}"),
            verbose=False, use_engine=engine)
        got = {n: w.launches for n, w in serving.items()}
        want = dict.fromkeys(serving, len(loader) if engine else 0)
        if got != want or any(v != (0, 0) for v in
                              read_counts(wrappers).values()):
            failures.append(f"test_model(use_engine={engine}): serving "
                            f"launches {got}, training "
                            f"{read_counts(wrappers)}")
        # timed warm: the first call above loaded the kernels and planned
        # cuDNN; the median of TEST_MODEL_CALLS more calls of one batch
        times = []
        for _ in range(TEST_MODEL_CALLS):
            stats = {}
            test_driver.test_model(
                loader, model, cfg, save_path=str(root / f"engine_{engine}"),
                verbose=False, use_engine=engine, stats=stats)
            times.append(stats["ms_per_batch"])
        ms[engine] = statistics.median(times)
    images = torch.from_numpy(next(iter(loader))["image"]).to(dev)
    engine = FusedLaneNetEngine(cfg, device=dev)
    packed = engine.prepare(model.state_dict())
    with torch.no_grad():
        got, ref = engine(packed, images), model(images)
    errs = {}
    for (key, bar), a, b in zip(ENGINE_BARS_TRAINED.items(), got,
                                (ref.beta, ref.line_logits,
                                 ref.horizon_logits)):
        err, errs[key] = rel_err(a, b)
        ok = bool(torch.isfinite(a).all().item()) and errs[key] <= bar
        print(f"test_model engine vs LaneNet.forward, {key}: max|diff| "
              f"{err:.3e}, {errs[key]:.2e} of max|LaneNet| "
              f"{b.abs().max().item():.3e} (tol {bar:g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"test_model engine {key}: {errs[key]:.2e} of "
                            f"max|LaneNet|")
    print(f"test_model: accuracy {accs[False]:.6f} on LaneNet.forward, "
          f"{accs[True]:.6f} through the engine (tol {ACC_TOL}); warm, "
          f"median of {TEST_MODEL_CALLS} calls: {ms[False]:.3f} / "
          f"{ms[True]:.3f} ms per batch of {cfg.batch_size} "
          f"({len(test_set)} real images) on {card}")
    if abs(accs[True] - accs[False]) > ACC_TOL:
        failures.append(f"test_model engine accuracy {accs[True]} vs "
                        f"{accs[False]}")
    epochs = len(rows)
    summary = {
        "card": card, "epochs": epochs,
        "fit_2_epochs_s": fit_s, "resume_1_epoch_s": resume_s,
        "test_only_s": test_s, "evaluate_s": eval_s,
        "train_batch_ms": [1e3 * r["train_batch_time"] for r in rows],
        "train_images_per_s": [8 / r["train_batch_time"] for r in rows],
        "test_acc": [r["test_acc"] for r in rows],
        "eval_loss_rel_cpu": loss_rel, "eval_beta_rel_cpu": beta_rel,
        "test_model_ms_per_batch": ms[False],
        "test_model_engine_ms_per_batch": ms[True]}
    print(f"trainer: {fit_s / 2:.1f} s an epoch over the first 2 (wall, "
          f"with data, validation, test scoring and checkpoints), "
          f"{resume_s:.1f} s for the resumed epoch (with the Trainer's "
          f"start) on {card}")
    shutil.rmtree(root, ignore_errors=True)
    return summary, failures


# ----------------------------------------------------------------------
# Phase 4i: the staged schedule and the BEV command line
# ----------------------------------------------------------------------

# the train.sh flags through the staged schedule: epoch 1 skip, epoch 2
# seg (the pretraining head), epoch 3 e2e (the main head)
STAGED_ARGV = TRAINER_ARGV + ["--pretrained", "true", "--pretrain_epochs",
                              "2", "--skip_epochs", "1"]
STAGED_PHASES = ("skip", "seg", "e2e")
# the BEV profile with its four lanes and heads, so that validation writes
# every image's beta, its TuSimple lines (write_lsq_results) and acc_seg
# The BEV beta of the card against the CPU's, per coefficient, at
# BETA_COLUMN_TOL of its column's largest value. TOL_F32 of max|beta|, the
# BP bar of 4g, is out of reach of two float32 backbones here: the BEV
# fit is sensitive to its logits, and its columns are of one scale, where
# the BP beta's largest column (pixels) hides the error of its small ones.
# A float64 witness (bev_beta_witness) says how far each side lies from
# exact arithmetic; the card is held against it at the same bar, and a
# control, the witness's logits rounded to BETA_CONTROL first, must read
# above the bar in the same run. Measured on an H100: card against CPU
# 1.6e-4-3.4e-4 of a column over seven runs; against float64 the card
# 2.1e-4-3.3e-4, the CPU 3.7e-5-4.7e-5 (3xTF32 keeps less of each product
# than an f32 FMA), the logits rounded to TF32 2.8e-4-5.2e-4 and to bf16
# 2.6e-3-3.7e-3 (two runs): the bar sits 3x above the largest reading and
# 2.6x below the smallest bf16 control. Scaling the logits (phase 3c's
# control) moves no beta:
# the fit is invariant to a uniform scale of its weights. The loss and
# the exact area stay at TOL_F32.
BETA_COLUMN_TOL = 1e-3
BETA_CONTROL = "bf16"
BEV_ARGV = ("--profile bev --nclasses 4 --clas 1 --synthetic 32 "
            "--split_percentage 0.25 --resize 256 --batch_size 8 "
            "--save_freq 3 --print_freq 1").split()


@contextlib.contextmanager
def watch_resume():
    """Record, in the dict it yields, where a resumed Trainer starts and
    whether its weights equal the checkpoint's bit for bit."""
    from lanedetection_end2end_tpu_torch.train import driver
    from lanedetection_end2end_tpu_torch.train.checkpoint import _ckpt_path
    resumed = {}
    resume = driver.Trainer.maybe_resume

    def watched(self):
        ok = resume(self)
        if ok:
            ckpt = torch.load(_ckpt_path(self.save_path,
                                         self.start_epoch - 1),
                              map_location="cpu", weights_only=False)
            sd = ckpt["state_dict"]["model"]
            resumed.update(start=self.start_epoch, equal=all(
                torch.equal(v.cpu(), sd[k])
                for k, v in self.lanenet.state_dict().items()))
        return ok

    driver.Trainer.maybe_resume = watched
    try:
        yield resumed
    finally:
        driver.Trainer.maybe_resume = resume


@contextlib.contextmanager
def record_eval_inputs():
    """Record, in the dict it yields, the Trainer's model ("model"), the
    images of every eval step it runs ("images"), as the step prepares
    them, and the step's outputs on the host ("outputs")."""
    from lanedetection_end2end_tpu_torch.train import driver
    from lanedetection_end2end_tpu_torch.train.steps import prepare_batch
    seen = {"images": [], "outputs": []}
    make = driver.Trainer.eval_step_for

    def watched(self, phase):
        step = make(self, phase)
        seen["model"] = self.lanenet

        def recorded(batch):
            seen["images"].append(prepare_batch(batch)["image"].cpu())
            metrics, outputs = step(batch)
            seen["outputs"].append({k: v.float().cpu()
                                    for k, v in outputs.items()})
            return metrics, outputs
        return recorded

    driver.Trainer.eval_step_for = watched
    try:
        yield seen
    finally:
        driver.Trainer.eval_step_for = make


def bev_beta_witness(model, images):
    """The BEV beta of `model` on `images` (B, H, W, 3) float32 with every
    operation in float64 on the CPU: `LaneNet.forward`'s e2e graph in eval
    mode, then the separable fit on the fitter's float32 constants taken
    as exact. -> {"float64": beta, "tf32": beta, "bf16": beta}: beta of the
    float64 logits and, as controls, of those logits rounded to TF32 or to
    bf16 first."""
    import copy
    from lanedetection_end2end_tpu_torch.ops.tf32x3 import round_tf32
    net = copy.deepcopy(model).cpu().double().eval()
    with torch.no_grad():
        _, dec, _ = net.net(images.cpu().double().permute(0, 3, 1, 2),
                            None, use_main_head=True)
    dec = dec.permute(0, 2, 3, 1)                           # (B, H, W, C)
    f = net.fitter
    mask, xs = net._mask.cpu().double(), f.sep_xs.cpu().double()
    coeff = f.sep_coeff.cpu().double()

    def fit(logits):
        B, H, W, C = logits.shape
        w2 = (net._act(logits) * mask) ** 2
        S0 = w2.sum(dim=2).transpose(1, 2)
        S1 = (w2 * xs[None, None, :, None]).sum(dim=2).transpose(1, 2)
        S = torch.cat([S0.reshape(B * C, -1), S1.reshape(B * C, -1)], -1)
        return f._finish((S.unsqueeze(-1) * coeff).sum(dim=1).cpu(), B, C
                         ).cpu()

    return {"float64": fit(dec), "tf32": fit(round_tf32(dec.float()).double()),
            "bf16": fit(dec.to(torch.bfloat16).double())}


def staged_phase(dev, card):
    """Phase 4i, both through `main_torch.main` at 256x512, batch 8,
    float32 on one 32-image synthetic set, with the kernels' launch counts
    set to 0 just before each call and read just after:

    - the train.sh flags with `--pretrained true --pretrain_epochs 2
      --skip_epochs 1`, one epoch a call (a resume each time): epoch 1
      skip and epoch 2 seg launch no kernel (their steps run on the plain
      graph; the skip epoch validates nothing, the seg epoch validates
      with the seg step), epoch 3 e2e launches 4g's counts; the seg
      epoch's checkpoint holds the pretraining head, and the e2e epoch
      starts from it bit for bit; every loss finite;
    - `--profile bev` with 4 lanes and the heads, 2 epochs (4g's counts
      an epoch), then `--evaluate` on the card against the same with
      `--no_cuda true`: validation loss and exact area at TOL_F32, every
      fitted beta at BETA_COLUMN_TOL of its coefficient's column, and the
      card's at that bar of a float64 witness on the CPU (the best
      checkpoint on the CPU run's validation images), whose logits
      rounded to BETA_CONTROL must read above it.

    Returns (summary, failures)."""
    import shutil
    from pathlib import Path

    import main_torch
    from lanedetection_end2end_tpu_torch.data.labels import read_json_lines
    from lanedetection_end2end_tpu_torch.data.synthetic import (
        make_synthetic_root)
    from lanedetection_end2end_tpu_torch.ops.backbone_fused import (
        decoder_fused_kernel, encoder_fused_kernel)
    from lanedetection_end2end_tpu_torch.train.checkpoint import _ckpt_path

    root = Path(__file__).resolve().parent / "_smoke" / "staged"
    shutil.rmtree(root, ignore_errors=True)
    make_synthetic_root(str(root / "synthetic_data"), num_train=32,
                        num_test=4, seed=0)
    wrappers = train_wrappers()
    serving = (encoder_fused_kernel, decoder_fused_kernel)
    failures, summary = [], {}

    def counted(label, argv, want):
        reset_counts(wrappers)
        for w in serving:
            w.launches = 0
        out, secs = _main_torch(argv + ["--save_path", str(root)])
        got = read_counts(wrappers)
        print(f"staged {label}: {secs:.1f} s, launches "
              + str({n: v for n, v in got.items() if v != (0, 0)}))
        if got != want or any(w.launches for w in serving):
            failures.append(f"{label}: launches {got}, expected {want}")
        return out, secs

    # the staged schedule, one epoch a call -----------------------------
    cfg = main_torch.parse_args(STAGED_ARGV)[0]
    run = root / cfg.save_id
    secs = {}
    for epoch, phase in enumerate(STAGED_PHASES):
        if cfg.phase_for_epoch(epoch) != phase:
            failures.append(f"epoch {epoch + 1} is "
                            f"{cfg.phase_for_epoch(epoch)}, not {phase}")
        want = (_expected(TRAIN_BATCHES, VAL_BATCHES) if phase == "e2e"
                else _expected(0, 0))
        with watch_resume() as resumed:
            _, secs[phase] = counted(
                f"epoch {epoch + 1} ({phase})",
                STAGED_ARGV + ["--nepochs", str(epoch + 1)], want)
        if epoch and resumed != {"start": epoch, "equal": True}:
            failures.append(f"{phase} epoch resumed {resumed}, expected a "
                            f"start at epoch {epoch + 1} with the "
                            "checkpoint's weights bit for bit")
        if phase == "seg":
            sd = torch.load(_ckpt_path(str(run), epoch), map_location="cpu",
                            weights_only=False)["state_dict"]["model"]
            if "net.decoder.output_conv2.weight" not in sd:
                failures.append("the seg epoch's checkpoint has no "
                                "output_conv2")
    rows = read_json_lines(str(run / "scalars.jsonl"))
    if [r["epoch"] for r in rows] != [1, 2, 3]:
        failures.append(f"staged epochs {[r['epoch'] for r in rows]}")
    batch_ms = {}
    for r, phase in zip(rows, STAGED_PHASES):
        losses = {k: v for k, v in r.items() if "loss" in k or "rmse" in k}
        validated = "val_loss" in r
        batch_ms[phase] = 1e3 * r["train_batch_time"]
        print(f"staged epoch {r['epoch']} ({phase}): {losses}, validated "
              f"{validated}, {batch_ms[phase]:.1f} ms a training batch "
              f"(the mean of {TRAIN_BATCHES}, data wait included) on {card}")
        if (not all(map(math.isfinite, losses.values()))
                or validated != (phase != "skip")):
            failures.append(f"staged epoch {r['epoch']}: {losses}, "
                            f"validated {validated}")
    if not (run / "example" / "pretrain" / "idx-0_batch-3.png").exists():
        failures.append("no skip-phase panel at training batch 3")
    summary["staged"] = {"train_batch_ms": batch_ms, "seconds": secs,
                         "card": card}

    # the BEV command line ---------------------------------------------
    cfg = main_torch.parse_args(BEV_ARGV)[0]
    run = root / cfg.save_id
    _, fit_s = counted("BEV fit, 2 epochs", BEV_ARGV + ["--nepochs", "2"],
                       _expected(2 * TRAIN_BATCHES, 2 * VAL_BATCHES))
    rows = read_json_lines(str(run / "scalars.jsonl"))
    for r in rows:
        vals = {k: r[k] for k in ("train_loss", "val_loss", "val_exact_area",
                                  "val_acc_seg")}
        print(f"BEV epoch {r['epoch']}: {vals}, "
              f"{1e3 * r['train_batch_time']:.1f} ms a training batch on "
              f"{card}")
        if not all(map(math.isfinite, vals.values())):
            failures.append(f"BEV epoch {r['epoch']}: {vals}")
    if not (run / "ls_result.json").exists():
        failures.append("BEV validation wrote no ls_result.json")
    argv = BEV_ARGV + ["--nepochs", "2", "--evaluate"]
    card_eval, eval_s = counted("BEV --evaluate", argv,
                                _expected(0, VAL_BATCHES))
    card_beta = [r["params"] for r in read_json_lines(
        str(run / "validation_set_dst.json"))]
    with record_eval_inputs() as seen:
        cpu_eval, cpu_s = _main_torch(argv + ["--no_cuda", "true",
                                              "--save_path", str(root)])
    cpu_beta = [r["params"] for r in read_json_lines(
        str(run / "validation_set_dst.json"))]
    rels = {k: abs(card_eval[k] - cpu_eval[k]) / abs(cpu_eval[k])
            for k in ("loss", "exact_area")}
    cb, pb = torch.tensor(card_beta), torch.tensor(cpu_beta)

    def columns(got, want):
        return [rel_err(got[..., i], want[..., i])[1]
                for i in range(want.shape[-1])]

    def shown(cols):
        return ", ".join(f"{n} {c:.2e}" for n, c in zip("abc", cols))

    beta_cols = columns(cb, pb)
    beta_max = rel_err(cb, pb)[1]
    print("BEV --evaluate beta, card vs CPU: max|diff| of each coefficient's"
          f" column max|CPU| {shown(beta_cols)} (tol {BETA_COLUMN_TOL:g}); "
          f"of max|beta| {beta_max:.2e}; per lane " + ", ".join(
              f"{k} {rel_err(cb[:, k], pb[:, k])[1]:.2e}"
              for k in range(cb.shape[1])))
    t0 = time.perf_counter()
    witness = {k: v[:len(cpu_beta), :cb.shape[1]] for k, v in
               bev_beta_witness(seen["model"],
                                torch.cat(seen["images"])).items()}
    exact = witness["float64"]
    against = {"card": columns(cb, exact), "cpu": columns(pb, exact),
               **{f"{k} logits": columns(v, exact)
                  for k, v in witness.items() if k != "float64"}}
    print(f"BEV --evaluate beta against the float64 witness "
          f"({time.perf_counter() - t0:.1f} s on the CPU), of each column's "
          "max|float64|: " + "; ".join(f"{k} {shown(v)}"
                                      for k, v in against.items())
          + f" (the {BETA_CONTROL} control must read above "
          f"{BETA_COLUMN_TOL:g})")
    ok = (max(rels.values()) <= TOL_F32
          and max(beta_cols) <= BETA_COLUMN_TOL
          and max(against["card"]) <= BETA_COLUMN_TOL
          and max(against[f"{BETA_CONTROL} logits"]) > BETA_COLUMN_TOL
          and len(card_beta) == len(cpu_beta) > 0)
    rels.update(beta_columns=beta_cols, beta_of_max=beta_max,
                float64_witness=against)
    print(f"BEV --evaluate, card vs CPU ({cpu_s:.1f} s): loss "
          f"{card_eval['loss']:.8g} / {cpu_eval['loss']:.8g}, exact_area "
          f"{card_eval['exact_area']:.8g} / {cpu_eval['exact_area']:.8g}, "
          f"acc_seg {card_eval['acc_seg']:.6f} / {cpu_eval['acc_seg']:.6f}; "
          f"relative loss {rels['loss']:.2e}, exact_area "
          f"{rels['exact_area']:.2e} (tol {TOL_F32:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"BEV --evaluate card vs CPU: {rels}")
    summary["bev_cli"] = {
        "fit_2_epochs_s": fit_s, "evaluate_s": eval_s,
        "train_batch_ms": [1e3 * r["train_batch_time"] for r in rows],
        "eval_rel_cpu": rels, "card": card}
    shutil.rmtree(root, ignore_errors=True)
    return summary, failures


# ----------------------------------------------------------------------
# Phase 4j: the learned homography, and the e2e step on the plain graph
# ----------------------------------------------------------------------

# 4g's flags with the learned homography: its e2e steps, its validation
# and its test_model run LaneNet.forward (cuDNN and autograd), no kernel
LH_ARGV = TRAINER_ARGV + ["--learn_homography", "true"]
# Bars of phase 4j, each set from its card runs (H100 80GB HBM3, 700 W;
# the readings span them; seeded offsets up to 10 pixels, M 6.3e-2 of max|M| off the fixed
# matrix). M and M_inv against a float64 witness on the CPU, of
# max|witness|: the DLT bar of tests/test_torch_dlt.py, DLT_TOL (read: the
# card 2.8e-6 / 1.1e-5, the CPU 2.9e-6 / 1.2e-5); the control, the float32
# solve of the witness offsets' system rounded to TF32, must read above
# it (read 4.9e-3 / 2.5e-2).
DLT_TOL = 1e-4
# The card's eval forward against the CPU's: offsets, M, M_inv, line and
# horizon logits, of each one's max, at LH_TOL (read up to 1.0e-5, M_inv);
# beta against the CPU's and against the witness per coefficient column,
# of the column's max, at LH_BETA_TOL (read up to 6.8e-5 and 5.9e-5, the
# card's convolutions varying between runs; the CPU against float64
# 4.3e-5), 7x above the readings; the control, the
# witness's logits rounded to bf16, must read above it (read 2.5e-3 to
# 3.2e-3 in the three higher columns; 3.5e-5 in the constant one, whose
# max is the lane's pixel offset, so the control is held on the largest
# column's reading). The same bars hold `--evaluate` card against CPU on
# the trained weights (x_cal at LH_TOL, read 3.7e-6 to 5.7e-6; beta up
# to 5.3e-5).
LH_TOL, LH_BETA_TOL = 1e-4, 5e-4
# The step's as-drawn whole-gradient cosine, card against CPU, at least
# the card step against its own rerun less LH_NOISE_MARGIN, 4h's margin
# (read: card against CPU 0.99966, the rerun 0.9999988 to 0.9999993, the
# CPU against one input bit flipped 0.99920); damped, the whole and the
# head cosines at F32_DAMPED (read 0.9999996 and 0.9999995, ratio 7.2e-6
# to 9.1e-6 off 1).
LH_NOISE_MARGIN = 5e-3
# The head's as-drawn cosine, card against CPU: 1 - cosine at most
# LH_HEAD_GAP (read 2.4e-6; the rerun 2.2e-7 to 7.2e-7, the CPU against
# one input bit flipped 2.8e-6). The controls, the card step with M
# detached in the fit (the head's gradient through the loss alone) or in
# the loss (through the fit alone), must read above it (read 0.91 and
# 1.09: the two routes nearly cancel, so either alone lies near right
# angles to the head's gradient; their whole-gradient cosine reads
# 0.984).
LH_HEAD_GAP = 1e-4


@contextlib.contextmanager
def detached_M(route):
    """Within: the learned homography's matrices detached where `route`
    ("fit" or "loss") takes them, the control of phase 4j's head-gradient
    bar."""
    from lanedetection_end2end_tpu_torch.ops.losses import (
        BackprojectionLoss)
    from lanedetection_end2end_tpu_torch.ops.wls import WLSFitter
    cls, name, cut = {"fit": (WLSFitter, "fit_with_M", (1,)),
                      "loss": (BackprojectionLoss, "with_M", (3, 4))}[route]
    orig = getattr(cls, name)

    def detached(self, *args):
        return orig(self, *(a.detach() if i in cut else a
                            for i, a in enumerate(args)))

    setattr(cls, name, detached)
    try:
        yield
    finally:
        setattr(cls, name, orig)


def all_wrappers():
    """Every hand-written kernel's wrapper, training and serving."""
    from lanedetection_end2end_tpu_torch.ops.backbone import (
        downsampler, head_rowsums, upsampler)
    from lanedetection_end2end_tpu_torch.ops.backbone_fused import (
        decoder_fused_kernel, encoder_fused_kernel)
    from lanedetection_end2end_tpu_torch.ops.nb1d import nb1d, nb1d_chain
    from lanedetection_end2end_tpu_torch.ops.wls_moments import wls_moments
    return {**train_wrappers(), "nb1d": nb1d, "nb1d_chain": nb1d_chain,
            "downsampler": downsampler, "upsampler": upsampler,
            "head_rowsums": head_rowsums,
            "encoder_fused": encoder_fused_kernel,
            "decoder_fused": decoder_fused_kernel,
            "wls_moments": wls_moments}


def lh_witness(model, images):
    """The learned homography's eval forward of `model` on `images` (B, H,
    W, 3) float32 with every operation in float64 on the CPU (the
    fitter's float32 constants taken as exact) -> {offsets, M, M_inv,
    beta}, and two controls: "tf32 system", (M, M_inv) of the float32
    solve of the witness offsets' system with A and b rounded to TF32,
    and "bf16 logits", beta of the witness's logits rounded to bf16,
    fitted with the witness's M. The offsets are the head's float64
    pre-activation through tanh / 16, and the fit is its own: the rows
    of `WLSFitter.__init__` for each sample's M, contracted in float64."""
    import copy
    from lanedetection_end2end_tpu_torch.geometry.dlt import (
        dlt_matrices, dlt_system)
    from lanedetection_end2end_tpu_torch.models.lanenet import make_fitter
    from lanedetection_end2end_tpu_torch.ops.tf32x3 import round_tf32
    net = copy.deepcopy(model).cpu().double().eval()
    resize = net.cfg.resize
    f = make_fitter(net.cfg, "cpu")
    mask = net._mask.cpu().double()
    ys, xs = f.sep_ys.double(), f.sep_xs.double()

    def fit(logits, M):
        w2 = (net._act(logits) * mask) ** 2                 # (B, H, W, C)
        B, C = w2.shape[0], w2.shape[-1]
        S0, S1 = w2.sum(2), (w2 * xs[:, None]).sum(2)       # (B, H, C)
        D = M[:, 2, 1:2] * ys + M[:, 2, 2:3]                # (B, H)
        alpha = M[:, 0, 0:1] / D
        gamma = (M[:, 0, 1:2] * ys + M[:, 0, 2:3]) / D
        y_rows = (M[:, 1, 1:2] * ys + M[:, 1, 2:3]) / D
        y_rows = 1.0 - y_rows if f.normalized else (f.height - 1.0) - y_rows
        t = y_rows / f.y_scale
        Yr = torch.stack([t ** p for p in range(f.order, -1, -1)], -1)
        Z = torch.einsum("bhc,bhi,bhj->bcij", S0, Yr, Yr)
        X = torch.einsum("bhc,bhi->bci", S0 * (gamma + alpha * f.sep_x0)[
            ..., None] + S1 * (alpha * f.sep_sx)[..., None], Yr)
        return f._finish(torch.cat([Z.reshape(B * C, -1),
                                    X.reshape(B * C, -1)], -1), B, C)

    pre = {}
    hook = net.homography_head.fc_offsets.register_forward_hook(
        lambda m, i, o: pre.update(x=o))
    with torch.no_grad():
        enc, dec, _ = net.net(images.cpu().double().permute(0, 3, 1, 2),
                              None)
        net.homography_head(enc)
        hook.remove()
        offsets = torch.tanh(pre["x"]) / 16.0
        M, M_inv = dlt_matrices(torch.linalg.solve(
            *dlt_system(offsets, resize)))
        dec = dec.permute(0, 2, 3, 1)                       # (B, H, W, C)
        A, b = dlt_system(offsets.float(), resize)
        control = dlt_matrices(torch.linalg.solve(round_tf32(A),
                                                  round_tf32(b)))
        return {"offsets": offsets, "M": M, "M_inv": M_inv,
                "beta": fit(dec, M), "tf32 system": control,
                "bf16 logits": fit(dec.to(torch.bfloat16).double(), M)}


def beta_columns(got, want):
    """max|diff| of each coefficient column over its max|want|."""
    return [rel_err(got[..., i], want[..., i])[1]
            for i in range(want.shape[-1])]


def homography_phase(dev, card):
    """Phase 4j: `train_sh_config(resize=256, reg_ls=1.0,
    learn_homography=True)`, batch 8, float32, seeded weights, a seeded
    non-zero `fc_offsets` among them:

    (a) the eval forward (TF32 off) on the card against the same on the
        CPU: offsets, M, M_inv, line and horizon logits at LH_TOL of max,
        beta per coefficient column at LH_BETA_TOL; the card's M and
        M_inv against a float64 witness at DLT_TOL (its TF32 control
        above), its beta at LH_BETA_TOL (the bf16 control above);
    (b) no launch of any hand-written kernel's wrapper over the whole
        phase, read after each part;
    (c) one train step with dropout off, card against CPU: the loss at
        TOL_F32, the whole gradient's and the homography head's cosine at
        least the card step against its own rerun less LH_NOISE_MARGIN
        (beside the CPU step against itself with one input bit flipped),
        and with the residual branches damped (bn2 x BN2_DAMP) at
        F32_DAMPED; then 3 steps with dropout on: losses finite, the
        `fc_offsets` gradient non-zero, ms per step (median of 3);
    (d) `main_torch.main --learn_homography true` on 4g's flags: 2
        epochs, a resume to 3 bit for bit, `--test_only` through
        `compute_coordinates_with_M` reproducing the best epoch's test
        accuracy, `--evaluate` on the card against `--no_cuda true`:
        loss at TOL_F32, x_cal at LH_TOL of max, beta per column at
        LH_BETA_TOL, test accuracy within ACC_TOL;
    (e) 4g's flags with `--packed_train false`, one epoch.

    Returns (summary, failures)."""
    import shutil
    from pathlib import Path

    import main_torch
    from lanedetection_end2end_tpu_torch.config import train_sh_config
    from lanedetection_end2end_tpu_torch.data.labels import read_json_lines
    from lanedetection_end2end_tpu_torch.data.synthetic import (
        make_synthetic_root)
    from lanedetection_end2end_tpu_torch.eval.projections import Projections
    from lanedetection_end2end_tpu_torch.geometry import bev_matrices_pixel
    from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
    from lanedetection_end2end_tpu_torch.train.checkpoint import (
        best_checkpoint_path)
    from lanedetection_end2end_tpu_torch.train.optim import define_optim
    from lanedetection_end2end_tpu_torch.train.steps import (
        make_train_step, prepare_batch)

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    failures, summary = [], {"card": card}
    wrappers = all_wrappers()
    reset_counts(wrappers)

    def no_launches(label):
        got = {n: v for n, v in read_counts(wrappers).items() if v != (0, 0)}
        if got:
            failures.append(f"{label}: kernel launches {got}")

    def hold(label, value, bar, above=False):
        ok = value > bar if above else value <= bar
        if not ok:
            failures.append(f"{label}: {value:.3e} "
                            f"({'above' if not above else 'at or under'} "
                            f"{bar:g})")
        return "ok" if ok else "FAIL"

    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0, learn_homography=True)
    # seeded like every other kernel, fc_offsets moves the trapezoid by a
    # few pixels (printed)
    sd = random_state_dict(LaneNet(cfg, device=dev), SEED)
    models = {"card": LaneNet(cfg, device=dev),
              "cpu": LaneNet(cfg, device="cpu")}
    batch = synthetic_batch(SEED + 3)
    images = prepare_batch(dict(batch))["image"]

    # (a) the eval forward ---------------------------------------------
    outs = {}
    for where, model in models.items():
        model.load_state_dict(sd)
        with torch.no_grad():
            o = model(images.to(next(model.parameters()).device))
            offsets = model.homography_head(
                o.encoder_features.permute(0, 3, 1, 2))
        outs[where] = {"offsets": offsets.cpu(), "M": o.M.cpu(),
                       "M_inv": o.M_inv.cpu(), "line": o.line_logits.cpu(),
                       "horizon": o.horizon_logits.cpu(),
                       "beta": o.beta.cpu()}
    sync()
    t0 = time.perf_counter()
    wit = lh_witness(models["cpu"], images)
    wit_s = time.perf_counter() - t0
    c, p = outs["card"], outs["cpu"]
    px = (c["offsets"] * torch.tensor([2.0 * RESIZE, 2.0 * RESIZE,
                                       RESIZE])).abs()
    fixed = torch.from_numpy(bev_matrices_pixel(RESIZE)[0])
    print(f"learned homography: offsets of the seeded head up to "
          f"{px.max().item():.2f} pixels (mean {px.mean().item():.2f}); M "
          f"moves {rel_err(c['M'], fixed)[1]:.3e}"
          f" of max|M| off the fixed matrix, on {card}")
    read = {}
    for k in ("offsets", "M", "M_inv", "line", "horizon"):
        read[k] = rel_err(c[k], p[k])[1]
        print(f"learned homography eval forward, card vs CPU, {k}: "
              f"{read[k]:.3e} of max|CPU| (tol {LH_TOL:g}) "
              f"{hold(f'eval {k} card vs CPU', read[k], LH_TOL)} on {card}")
    cols = {"card vs CPU": beta_columns(c["beta"], p["beta"]),
            "card vs float64": beta_columns(c["beta"], wit["beta"]),
            "CPU vs float64": beta_columns(p["beta"], wit["beta"]),
            "bf16 logits vs float64": beta_columns(wit["bf16 logits"],
                                                   wit["beta"])}
    for k in ("card vs CPU", "card vs float64"):
        hold(f"eval beta {k}", max(cols[k]), LH_BETA_TOL)
    hold("eval beta bf16 control", max(cols["bf16 logits vs float64"]),
         LH_BETA_TOL, above=True)
    print("learned homography eval beta per coefficient column, of the "
          "column's max: " + "; ".join(
              f"{k} " + ", ".join(f"{v:.2e}" for v in vs)
              for k, vs in cols.items())
          + f" (tol {LH_BETA_TOL:g}; the bf16 control must read above; "
          f"the float64 witness took {wit_s:.1f} s on the CPU) on {card}")
    dlt = {}
    for i, k in enumerate(("M", "M_inv")):
        dlt[k] = {"card": rel_err(c[k], wit[k])[1],
                  "cpu": rel_err(p[k], wit[k])[1],
                  "tf32 system": rel_err(wit["tf32 system"][i], wit[k])[1]}
        hold(f"{k} card vs float64", dlt[k]["card"], DLT_TOL)
        hold(f"{k} TF32 control", dlt[k]["tf32 system"], DLT_TOL, above=True)
        print(f"learned homography {k} against the float64 witness, of its "
              f"max: card {dlt[k]['card']:.3e}, CPU {dlt[k]['cpu']:.3e}, "
              f"the TF32-rounded system {dlt[k]['tf32 system']:.3e} (tol "
              f"{DLT_TOL:g}, the control must read above) on {card}")
    summary["eval"] = {"card_vs_cpu": read, "beta_columns": cols,
                       "dlt_vs_float64": dlt,
                       "offsets_max_px": px.max().item()}
    no_launches("eval forward")

    # (c) train steps --------------------------------------------------
    def one_step(where, weights, b=batch, gen=None, step=None):
        model = models[where]
        if step is None:
            model.load_state_dict(weights)
            opt = define_optim(model.parameters(), cfg.optimizer,
                               cfg.learning_rate, cfg.weight_decay,
                               cfg.clip_grad_norm)
            step = make_train_step(
                model, cfg, opt,
                device=next(model.parameters()).device)
        sync()
        t0 = time.perf_counter()
        metrics = step(b, gen)
        sync()
        ms = 1e3 * (time.perf_counter() - t0)
        grads = {k: p.grad.detach().float().flatten().cpu()
                 for k, p in model.named_parameters() if p.grad is not None}
        return metrics["loss"].item(), grads, ms, step

    def head(grads):
        return {k: v for k, v in grads.items()
                if k.startswith("homography_head.")}

    def cosines(a, b):
        return (cosine(whole(a), whole(b)), cosine(whole(head(a)),
                                                   whole(head(b))),
                (whole(a).norm() / whole(b).norm()).item())

    loss_c, g_c, _, _ = one_step("card", sd)
    loss_p, g_p, cpu_ms, _ = one_step("cpu", sd)
    _, g_r, _, _ = one_step("card", sd)
    nudged = dict(batch, image=batch["image"].clone())
    nudged["image"][0, RESIZE // 2, RESIZE, 0] ^= 1
    _, g_n, _, _ = one_step("cpu", sd, nudged)
    damped = {k: v * BN2_DAMP if k.endswith("bn2.weight") else v
              for k, v in sd.items()}
    loss_cd, g_cd, _, _ = one_step("card", damped)
    loss_pd, g_pd, _, _ = one_step("cpu", damped)
    # the controls: the card step with the head's gradient cut on one of
    # its two routes, M detached in the fit or in the loss
    controls = {}
    for route in ("fit", "loss"):
        with detached_M(route):
            controls[route] = one_step("card", sd)[1]
    step_read = {"loss_rel": abs(loss_c - loss_p) / abs(loss_p),
                 "damped_loss_rel": abs(loss_cd - loss_pd) / abs(loss_pd),
                 "card_vs_cpu": cosines(g_c, g_p),
                 "card_vs_rerun": cosines(g_c, g_r),
                 "cpu_vs_nudged": cosines(g_p, g_n),
                 "damped_card_vs_cpu": cosines(g_cd, g_pd),
                 **{f"M_detached_in_{r}_vs_cpu": cosines(g, g_p)
                    for r, g in controls.items()}}
    (cw, ch, _), (rw, _, _) = (step_read["card_vs_cpu"],
                               step_read["card_vs_rerun"])
    dw, dh, dratio = step_read["damped_card_vs_cpu"]
    verdict = [hold("step loss card vs CPU", step_read["loss_rel"], TOL_F32),
               hold("damped step loss", step_read["damped_loss_rel"],
                    TOL_F32),
               hold("step whole-gradient cosine", rw - LH_NOISE_MARGIN - cw,
                    0.0),
               hold("step head-gradient cosine gap", 1 - ch, LH_HEAD_GAP),
               hold("damped whole-gradient cosine", F32_DAMPED[0] - dw, 0.0),
               hold("damped head-gradient cosine", F32_DAMPED[0] - dh, 0.0),
               hold("damped norm ratio", abs(dratio - 1), F32_DAMPED[1])]
    verdict += [hold(f"control, M detached in the {r}: head cosine gap",
                     1 - step_read[f"M_detached_in_{r}_vs_cpu"][1],
                     LH_HEAD_GAP, above=True) for r in controls]
    shown = lambda k: tuple(round(x, 8) for x in step_read[k])
    print(f"learned homography train step, card vs CPU (dropout off, "
          f"{len(g_c)} leaves): loss {loss_c:.8g} / {loss_p:.8g} (rel "
          f"{step_read['loss_rel']:.2e}, tol {TOL_F32:g}); (whole cosine, "
          f"head cosine, norm ratio): card vs CPU {shown('card_vs_cpu')} "
          f"(head: 1 - cosine within {LH_HEAD_GAP:g}), card vs its rerun "
          f"{shown('card_vs_rerun')} (the whole bar: that less "
          f"{LH_NOISE_MARGIN:g}), CPU vs one input bit flipped "
          f"{shown('cpu_vs_nudged')}; bn2 x {BN2_DAMP}: loss rel "
          f"{step_read['damped_loss_rel']:.2e}, "
          f"{shown('damped_card_vs_cpu')} (least {F32_DAMPED[0]}, ratio "
          f"within {F32_DAMPED[1]:g}); the controls, card with M detached "
          f"in the fit {shown('M_detached_in_fit_vs_cpu')}, in the loss "
          f"{shown('M_detached_in_loss_vs_cpu')} (head: 1 - cosine must "
          f"read above {LH_HEAD_GAP:g}); {', '.join(verdict)}; the CPU step "
          f"took {cpu_ms:.0f} ms on {card}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    losses, step_ms, step = [], [], None
    for _ in range(TRAIN_STEPS):
        loss, grads, ms, step = one_step("card", sd, gen=gen, step=step)
        losses.append(loss)
        step_ms.append(ms)
        fc = grads["homography_head.fc_offsets.weight"]
        if not (math.isfinite(loss) and torch.isfinite(whole(grads)).all()
                and fc.abs().max().item() > 0):
            failures.append(f"dropout-on step: loss {loss}, fc_offsets "
                            f"max|g| {fc.abs().max().item()}")
    ms = statistics.median(step_ms)
    print(f"learned homography train steps, dropout on: losses "
          f"{', '.join(f'{v:.6g}' for v in losses)}; {ms:.3f} ms per step "
          f"of {BATCH} (median of {TRAIN_STEPS}: "
          f"{', '.join(f'{t:.3f}' for t in step_ms)}), "
          f"{1e3 * BATCH / ms:.1f} images/s, host clock, on {card}")
    summary["step"] = dict(step_read, losses=losses, step_ms=step_ms,
                           ms_per_step=ms)
    no_launches("train steps")

    # (d) main_torch.py with the learned homography ----------------------
    root = Path(__file__).resolve().parent / "_smoke" / "homography"
    shutil.rmtree(root, ignore_errors=True)
    lh_cfg = main_torch.parse_args(LH_ARGV)[0]
    make_synthetic_root(str(root / "synthetic_data"), num_train=32,
                        num_test=4, seed=lh_cfg.seed)
    argv = LH_ARGV + ["--save_path", str(root)]
    run = root / lh_cfg.save_id
    with_M_calls = []
    with_M = Projections.compute_coordinates_with_M

    def counted_with_M(self, *a):
        with_M_calls.append(a[0].shape[0])
        return with_M(self, *a)

    def counted(label, extra):
        reset_counts(wrappers)
        out, secs = _main_torch(argv + extra)
        no_launches(label)
        print(f"learned homography {label}: {secs:.1f} s on {card}")
        return out, secs

    Projections.compute_coordinates_with_M = counted_with_M
    try:
        with watch_resume() as resumed:
            _, fit_s = counted("fit, 2 epochs", ["--nepochs", "2"])
            _, resume_s = counted("resume to 3", ["--nepochs", "3"])
        fit_calls = len(with_M_calls)
        if resumed != {"start": 2, "equal": True}:
            failures.append(f"learned homography resume: {resumed}")
        rows = read_json_lines(str(run / "scalars.jsonl"))
        for r in rows:
            vals = {k: r[k] for k in ("train_loss", "val_loss", "test_acc")}
            print(f"learned homography epoch {r['epoch']}: {vals}, "
                  f"{1e3 * r['train_batch_time']:.1f} ms a training batch "
                  f"(the mean of {TRAIN_BATCHES}, data wait included) on "
                  f"{card}")
            if not all(map(math.isfinite, vals.values())):
                failures.append(f"learned homography epoch {r['epoch']}: "
                                f"{vals}")
        if [r["epoch"] for r in rows] != [1, 2, 3]:
            failures.append(f"learned homography epochs "
                            f"{[r['epoch'] for r in rows]}")
        best = best_checkpoint_path(str(run))
        ckpt = torch.load(best, map_location="cpu", weights_only=False)
        head_keys = [k for k in ckpt["state_dict"]["model"]
                     if k.startswith("homography_head.")]
        best_epoch = int(best.rsplit("_", 1)[1].split(".")[0])
        out, test_s = counted("--test_only", ["--nepochs", "3",
                                              "--test_only"])
        test_calls = len(with_M_calls) - fit_calls
        recorded = rows[best_epoch]["test_acc"]
        print(f"learned homography --test_only: accuracy {out['acc']:.8f}, "
              f"recorded at epoch {best_epoch + 1}: {recorded:.8f}; "
              f"compute_coordinates_with_M calls: {fit_calls} in the fit, "
              f"{test_calls} in --test_only; {len(head_keys)} "
              f"homography_head entries in the checkpoint; on {card}")
        if (out["acc"] != recorded or not fit_calls or not test_calls
                or len(head_keys) != 32):
            failures.append(f"learned homography --test_only: accuracy "
                            f"{out['acc']} vs {recorded}, with_M calls "
                            f"{fit_calls} / {test_calls}, head entries "
                            f"{len(head_keys)}")
        evals = {}
        for where, extra in (("card", []), ("cpu", ["--no_cuda", "true"])):
            with record_eval_inputs() as seen:
                res, secs = (counted("--evaluate", ["--nepochs", "3",
                                                    "--evaluate"])
                             if where == "card" else _main_torch(
                                 argv + ["--nepochs", "3", "--evaluate"]
                                 + extra))
            evals[where] = (res, torch.cat([o["beta"] for o in
                                            seen["outputs"]]),
                            torch.cat([o["x_cal"] for o in
                                       seen["outputs"]]), secs)
    finally:
        Projections.compute_coordinates_with_M = with_M
    (rc, bc, xc, _), (rp, bp, xp, cpu_s) = evals["card"], evals["cpu"]
    ev = {"loss_rel": abs(rc["loss"] - rp["loss"]) / abs(rp["loss"]),
          "x_cal": rel_err(xc, xp)[1], "beta_columns": beta_columns(bc, bp),
          "test_acc": (rc["test_acc"], rp["test_acc"])}
    verdict = [hold("--evaluate loss", ev["loss_rel"], TOL_F32),
               hold("--evaluate x_cal", ev["x_cal"], LH_TOL),
               hold("--evaluate beta", max(ev["beta_columns"]), LH_BETA_TOL),
               hold("--evaluate test accuracy",
                    abs(rc["test_acc"] - rp["test_acc"]), ACC_TOL)]
    print(f"learned homography --evaluate, card vs CPU ({cpu_s:.1f} s): "
          f"loss {rc['loss']:.8g} / {rp['loss']:.8g} (rel "
          f"{ev['loss_rel']:.2e}, tol {TOL_F32:g}), x_cal {ev['x_cal']:.2e} "
          f"of max|CPU| (tol {LH_TOL:g}), beta per column "
          f"{', '.join(f'{v:.2e}' for v in ev['beta_columns'])} (tol "
          f"{LH_BETA_TOL:g}), test accuracy {rc['test_acc']:.6f} / "
          f"{rp['test_acc']:.6f} (tol {ACC_TOL}); {', '.join(verdict)} on "
          f"{card}")
    summary["cli"] = {"fit_2_epochs_s": fit_s, "resume_1_epoch_s": resume_s,
                      "test_only_s": test_s,
                      "train_batch_ms": [1e3 * r["train_batch_time"]
                                         for r in rows],
                      "evaluate_vs_cpu": ev}

    # (e) packed_train false -------------------------------------------
    plain_root = root / "plain"
    plain_argv = TRAINER_ARGV + ["--packed_train", "false", "--save_path",
                                 str(plain_root)]
    shutil.copytree(root / "synthetic_data", plain_root / "synthetic_data")
    reset_counts(wrappers)
    _, plain_s = _main_torch(plain_argv + ["--nepochs", "1"])
    no_launches("--packed_train false")
    rows = read_json_lines(str(plain_root / main_torch.parse_args(
        plain_argv)[0].save_id / "scalars.jsonl"))
    vals = {k: rows[-1][k] for k in ("train_loss", "val_loss")}
    print(f"--packed_train false, 1 epoch: {plain_s:.1f} s, {vals}, "
          f"{1e3 * rows[-1]['train_batch_time']:.1f} ms a training batch, "
          f"no kernel launch, on {card}")
    if len(rows) != 1 or not all(map(math.isfinite, vals.values())):
        failures.append(f"--packed_train false: {rows}")
    summary["packed_train_false"] = {"epoch_s": plain_s, "losses": vals}
    shutil.rmtree(root, ignore_errors=True)
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"learned homography phase: {summary['phase_s']:.1f} s on {card}")
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


def f_calls_expected(path: str, clas: bool) -> dict:
    """Calls of torch.nn.functional per train step on `path`; without the
    heads, none of theirs."""
    heads = {"conv2d": 8, "max_pool2d": 1, "conv_transpose2d": 0}
    return {n: c - (0 if clas else heads[n])
            for n, c in F_CALLS[path].items()}


def synthetic_bev_batch(seed: int) -> dict:
    """A seeded BEV batch of 8: the compact images and horizon of
    `synthetic_batch`, curve parameters (B, 4, 3) of lanes near the image
    centre in normalized coordinates, and line types (B, 4)."""
    g = torch.Generator().manual_seed(seed + 1)
    batch = synthetic_batch(seed)
    del batch["lanes"], batch["valid_points"]
    centre = torch.tensor([0.45, 0.55, 0.35, 0.65])
    params = torch.stack([0.05 * torch.randn(BATCH, 4, generator=g),
                          0.1 * torch.randn(BATCH, 4, generator=g),
                          centre + 0.02 * torch.randn(BATCH, 4, generator=g)],
                         dim=-1)
    batch.update(params=params,
                 line=torch.randint(0, 3, (BATCH, 4), generator=g))
    return batch


class Trainer:
    """A config at 256x512 in one compute dtype on one training path of
    the card (`fused_blocks`), seeded weights `sd0`, and the steps of
    phases 4, 4d and 4h on it: by default the train_sh config on a seeded
    BP batch."""

    def __init__(self, dev, sd0, dtype: str, fused_blocks: bool, cfg=None,
                 batch=None):
        from lanedetection_end2end_tpu_torch.config import train_sh_config
        from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
        self.cfg = cfg if cfg is not None else train_sh_config(
            resize=RESIZE, reg_ls=1.0, compute_dtype=dtype)
        self.model = LaneNet(self.cfg, device=dev)
        self.sd0, self.dev, self.fused_blocks = sd0, dev, fused_blocks
        self.batch = synthetic_batch(SEED + 3) if batch is None else batch
        self.label = (f"{dtype}, fused_blocks={fused_blocks}"
                      + (", BEV" if self.cfg.profile == "bev" else ""))
        self.metrics = {}

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
        self.metrics = {k: v.item() for k, v in metrics.items()}
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

    def hold_f32(self, noise_margin=None):
        """Phase 4d in float32: the step on the kernels against the step on
        their plain versions, on the seeded weights as drawn (beside the
        kernel step's own rerun) and with the residual branches damped
        (see the docstring for the bars). With `noise_margin`, the least
        cosine as drawn is the rerun's cosine less that margin, not
        F32_AS_DRAWN's (phase 4h). Returns {weights: cosine}."""
        loss_k, g_k, loss_p, g_p = self.kernels_vs_plain()
        _, g_r, _ = self.one_step(self.fresh_step(), None)
        read = {}
        for weights, (cos_min, ratio_tol) in (("seeded", F32_AS_DRAWN),
                                              ("damped", F32_DAMPED)):
            if weights == "damped":
                loss_k, g_k, loss_p, g_p = self.kernels_vs_plain(
                    self.damped())
            gk, gp = whole(g_k), whole(g_p)
            rel = abs(loss_k - loss_p) / abs(loss_p)
            cos, ratio = cosine(gk, gp), (gk.norm() / gp.norm()).item()
            rerun = ""
            if weights == "seeded":
                floor = cosine(gk, whole(g_r))
                read["rerun"] = floor
                rerun = (f"; the kernel step against its own rerun, whose "
                         f"f32 atomics add in another order: {floor:.8f}")
                if noise_margin is not None:
                    cos_min = floor - noise_margin
                    rerun += f", less {noise_margin:g}"
            read[weights] = cos
            print(f"train step ({self.label}), kernels vs plain versions, "
                  f"{weights} weights: loss {loss_k:.8g} vs {loss_p:.8g} "
                  f"(rel {rel:.3e}, tol {F32_LOSS:g}), whole gradient cosine "
                  f"{cos:.8f} (least {cos_min:.8g}{rerun}), norm ratio "
                  f"{ratio:.6f} (within {ratio_tol:g} of 1) over "
                  f"{gk.numel()} values")
            if not (rel <= F32_LOSS and cos >= cos_min
                    and abs(ratio - 1) <= ratio_tol
                    and torch.isfinite(gk).all().item()):
                fail(f"the {self.label} train step on the kernels disagrees "
                     f"with the step on their plain versions ({weights} "
                     "weights)")
        return read

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
        cfg, C = self.cfg, self.cfg.out_channels
        want = {"beta": (BATCH, C, cfg.order + 1)}
        if cfg.profile == "bp":
            want["x_cal"] = (BATCH, C, 56)
        if cfg.clas:
            want.update(line_pred=(BATCH, 4), horizon_pred=(BATCH, RESIZE))
        if (shapes != want
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
        f_want = f_calls_expected(path, self.cfg.clas)
        with count_calls(F, tuple(f_want)) as f_calls:
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
        if f_calls != {n: n_steps * c for n, c in f_want.items()}:
            fail(f"calls of torch.nn.functional {f_calls}, expected "
                 f"{f_want} per step")
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


def bev_train_phase(dev, profile=False):
    """Phase 4h: `bev_defaults(resize=256, nclasses=2)` in float32 (the
    config's dtype) on the default path, adam, seeded weights and a
    seeded BEV batch of 8: one step with dropout off on the kernels
    against the same step on their plain versions (phase 4's float32
    bars, except that the cosine as drawn is held against the kernel
    step's own rerun less BEV_NOISE_MARGIN), one eval step (K9's head at
    cout 2, forwards only), then 3 counted steps with dropout on (17 + 17
    of each half, 3 + 3 / 2 + 2 / 1 + 1 of K8-K10, K10 at C = 2), finite
    loss and exact area. The seeds are phase 4's: the encoder's weights
    and the images are phase 4's too (the draws of the decoder follow the
    2-lane predict head's). Returns (summary, launches of the 3 steps)."""
    from lanedetection_end2end_tpu_torch.config import bev_defaults
    from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
    cfg = bev_defaults(resize=RESIZE, nclasses=2)
    sd0 = random_state_dict(LaneNet(cfg, device=dev), SEED)
    tr = Trainer(dev, sd0, cfg.compute_dtype, fused_blocks=True, cfg=cfg,
                 batch=synthetic_bev_batch(SEED + 3))
    cosines = tr.hold_f32(noise_margin=BEV_NOISE_MARGIN)
    tr.eval_step("fused")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    step, counts, losses, step_ms = tr.counted_steps(TRAIN_STEPS, "fused",
                                                     gen)
    area = tr.metrics["exact_area"]
    moved = sum(int((p.detach() != sd0[k].to(dev)).any().item())
                for k, p in tr.model.named_parameters())
    n_params = sum(1 for _ in tr.model.parameters())
    if not math.isfinite(area) or moved < n_params - 2:
        fail(f"BEV train steps: exact_area {area}, {moved} of {n_params} "
             "parameter tensors moved")
    ms = tr.report(step_ms, losses, f"; exact_area {area:.6g}, {moved} of "
                   f"{n_params} parameter tensors moved")
    if profile:
        profile_steps(lambda: step(tr.batch, gen), ms, "BEV float32")
    return {"ms_per_step": ms, "step_ms": step_ms, "losses": losses,
            "exact_area": area, "cosine": cosines}, counts


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


def numbers(s):
    """A summary's numbers in the kernels line."""
    out = {"max_abs_err": s["max_abs_err"], "ms": s["ms"],
           "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
           "bound_by": ("operations" if 2 * s.get("ops_ms", 0.0)
                        > s["bound_ms"] else "bytes"),
           "library_ms": s.get("library_ms")}
    if "ffma_bound_ms" in s:
        out["ffma_bound_ms"] = s["ffma_bound_ms"]
    return out


def bwd_numbers(s):
    """A training kernel's backward numbers in the kernels line."""
    out = {"bwd_ms": s["bwd_ms"], "plain_bwd_ms": s["plain_bwd_ms"],
           "bwd_bound_ms": s["bwd_bound_ms"],
           "max_rel_err_reduce": s["max_rel_err_reduce"]}
    for key in ("bwd_library_ms", "bwd_ffma_bound_ms"):
        if key in s:
            out[key] = s[key]
    return out


def two_lane_entry(name, by_dtype, bev, bev_launches):
    """The kernels line's `two_lanes` object of kernel `name`: phase 2e's
    numbers per dtype, and the launches of the BEV paths (3 engine calls
    of phase 3e; the 3 counted steps of phase 4h, forward and backward)."""
    out = {}
    for dname, s in by_dtype.items():
        out[dname] = numbers(s)
        if "bwd_ms" in s:
            out[dname].update(bwd_numbers(s))
        if "blocks_ms" in s:
            out[dname]["block_sequence_ms"] = s["blocks_ms"]
    if name == "decoder_fused":
        out["launches"] = bev["serving"]["BEV engine, 2 lanes"][
            "launches"]["decoder_fused"]
    else:
        out["launches"], out["bwd_launches"] = bev_launches[name]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if "--race-child" in sys.argv[1:]:
        return race_child()
    if "--defer-only" in sys.argv[1:]:
        from lanedetection_end2end_tpu_torch.ops import _build
        _build.build(DEFER_SOURCES)
        _build.build(DEFER_SOURCES, "defer")
        _, failures = defer_check(torch.device("cuda", 0))
        if failures:
            fail("deferred copies: " + "; ".join(failures))
        return 0
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

    # 1. build (the deferred-copy variant of phase 4f beside it) ---------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        deferred_build = pool.submit(_build.build, DEFER_SOURCES, "defer")
        logs = _build.build()
        deferred_build.result()
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
    # 2e. the head kernels at two lanes ----------------------------------
    two_lanes, failures = check_two_lanes(dev, g)
    if failures:
        fail("two lanes: " + "; ".join(failures))

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
    # 3e. the BEV profile's engine ---------------------------------------
    bev = {"serving": serve_bev(dev, images, {n: wrappers[n] for n in
                                              ("encoder_fused",
                                               "decoder_fused",
                                               *SERVING, *BLOCKS)}, ms)}

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

    # 4h. the BEV profile's e2e step at two lanes -------------------------
    bev["train"], bev_launches = bev_train_phase(dev, profile=profile)

    # 4e. the race check of the row tile under compute-sanitizer --------
    race_report, failures = race_check()
    if failures:
        fail("race check: " + "; ".join(failures))

    # 4f. the deferred-copy build against the normal one -----------------
    defer_report, failures = defer_check(dev)
    if failures:
        fail("deferred copies: " + "; ".join(failures))

    # 4g. the training entry point, main_torch.py ------------------------
    trainer_summary, failures = trainer_phase(dev, card)
    if failures:
        fail("trainer: " + "; ".join(failures))
    # 4i. the staged schedule and the BEV command line -------------------
    staged, failures = staged_phase(dev, card)
    if failures:
        fail("staged schedule or BEV command line: " + "; ".join(failures))
    bev.update(staged)
    # 4j. the learned homography and the plain-graph e2e step ------------
    homography, failures = homography_phase(dev, card)
    if failures:
        fail("learned homography: " + "; ".join(failures))

    # 5. kernels line and result ----------------------------------------
    kernels = []
    path_launches = dict(block_launches)
    path_launches.update({n: launches[n] for n in FUSED})
    path_launches.update(blocks_launches, row12=row12_launches)
    path_launches.update({n: v[0]
                          for n, v in train_launches["bfloat16"].items()})

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
        if n in two_lanes:
            entry["two_lanes"] = two_lane_entry(n, two_lanes[n], bev,
                                                bev_launches)
        kernels.append(entry)
    print(card)
    print(json.dumps({"kernels": kernels, "wide": wide_summary,
                      "race_check": race_report,
                      "deferred_copies": defer_report,
                      "trainer": trainer_summary, "bev": bev,
                      "learned_homography": homography}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
