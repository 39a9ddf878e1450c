"""The whole serving encoder and the whole serving decoder, each as ONE
cooperative launch, with their plain versions.

Counterpart of `lanedetection_end2end_tpu/models/fused_graph.py`'s
`encoder_fused` / `decoder_fused`, which run through `_plane_call` (the
`pl.pallas_call` at :178) as one Pallas kernel per image each, every
intermediate plane in VMEM:

- `encoder_fused_kernel` (`csrc/encoder_fused.cu`): images (B, H, W, 3)
  bf16 -> enc (B, H/8, W/8, 128) bf16 through the initial downsampler,
  down1, 5 NB1D-64 blocks, down2 and 8 dilated NB1D-128 blocks: 29 passes
  with a grid-wide barrier between each pair (28);
- `decoder_fused_kernel` (`csrc/decoder_fused.cu`): enc -> S (B, H, 2C)
  f32 = [S0 | S1] through up1, 2 NB1D-64, up2, 2 NB1D-16 and the head with
  activation, row mask and WLS row sums: 11 passes, 10 barriers.

Each pass runs the device code of K1-K4 (`ops/nb1d.py`, `ops/backbone.py`),
so the outputs are bit for bit those of the block sequence
(`models/fused_graph.py::encoder_blocks` / `decoder_blocks`): the stride-2
passes on the tensor-core tiles of `csrc/conv_s2_mma.cuh` (the 3 -> 16
downsampler on FFMA), an NB1D block as two passes of the row tile of
`csrc/nb1d.cuh`. The planes stay in device memory (L2 at these sizes): one
card's blocks cannot hold an image's planes the way a TPU core's VMEM
does. Each launch writes the grid barriers it ran to a device int, kept
on the wrapper as `barriers` after a call; `fused_info` reads what the
card gives a launch (registers, spills, resident warps, grid).

The constants are laid out once per checkpoint (`flat_constants`, called by
`pack_encoder` / `pack_decoder`, the counterpart of JAX's `_flatten_packed`):
one bf16 buffer of every stage's weights, one f32 buffer of its vectors and
a table of offsets that the kernel takes by value, so a call casts, permutes
and stacks nothing. The wrappers take CUDA tensors only (a CPU tensor
raises); `encoder_plain` / `decoder_plain`, the block sequence on the
blocks' plain versions, are what `models/fused_graph.py` runs on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from lanedetection_end2end_tpu_torch.ops._build import (
    check_cuda, kernel, launch)
from lanedetection_end2end_tpu_torch.ops.backbone import (
    downsampler_plain, head_rowsums_plain, upsampler_plain)
from lanedetection_end2end_tpu_torch.ops.nb1d import nb1d_plain

BF16 = torch.bfloat16
F32 = torch.float32

# the kernels' stages, in the order of the offset table
ENC_STAGES = ("initial", "down1", *(("nb64", i) for i in range(5)), "down2",
              *(("nb128", i) for i in range(8)))
DEC_STAGES = ("up1", ("nb64", 0), ("nb64", 1), "up2", ("nb16", 0),
              ("nb16", 1), "head")


def stage_kind(key) -> str:
    """The block a stage runs: "down", "up", "nb1d" or "head"."""
    if isinstance(key, tuple):
        return "nb1d"
    return {"initial": "down", "down1": "down", "down2": "down",
            "up1": "up", "up2": "up", "head": "head"}[key]


def stage(packed: Dict, key) -> Dict:
    """A stage's per-block dict in `pack_encoder` / `pack_decoder`."""
    return packed[key[0]][key[1]] if isinstance(key, tuple) else packed[key]


PLAIN = {"down": downsampler_plain, "up": upsampler_plain,
         "nb1d": nb1d_plain, "head": head_rowsums_plain}


def run_stages(x: torch.Tensor, packed: Dict, stages: Sequence,
               ops: Dict = PLAIN) -> torch.Tensor:
    """The stages in order, each through `ops[stage_kind(key)]`: the
    blocks' plain versions by default, their wrappers for the block
    sequence (`models/fused_graph.py::encoder_blocks` / `decoder_blocks`)."""
    for key in stages:
        x = ops[stage_kind(key)](x, stage(packed, key))
    return x


def stage_arrays(p: Dict) -> Tuple[torch.Tensor, List[torch.Tensor], int]:
    """A stage's constants as the kernel reads them: (weights, the vectors
    laid end to end, dilation). A downsampler or upsampler: (w, [mul, add],
    0); an NB1D block: (w, [vec], d); the head: (w, [bias, xs], 0)."""
    if "vec" in p:
        return p["w"], [p["vec"]], p["dilation"]
    if "xs" in p:
        return p["w"], [p["bias"], p["xs"]], 0
    return p["w"], [p["mul"], p["add"]], 0


def flat_constants(packed: Dict, stages: Sequence) -> Dict:
    """Every stage's constants in one bf16 weight buffer `wbuf` and one f32
    vector buffer `vbuf`, each segment starting on 16 bytes, and the offset
    table: `table` = (weight offsets, vector offsets, dilations), one entry
    per stage, as a host int array the C entry reads."""
    ws, vs, w_off, v_off, dil = [], [], [], [], []
    nw = nv = 0
    for key in stages:
        w, vecs, d = stage_arrays(stage(packed, key))
        w = w.reshape(-1).to(BF16)
        v = torch.cat([t.reshape(-1).float() for t in vecs])
        w_off.append(nw)
        v_off.append(nv)
        dil.append(int(d))
        ws += [w, w.new_zeros(-w.numel() % 8)]
        vs += [v, v.new_zeros(-v.numel() % 4)]
        nw += w.numel() + (-w.numel() % 8)
        nv += v.numel() + (-v.numel() % 4)
    table = w_off + v_off + dil
    return {"wbuf": torch.cat(ws).contiguous(),
            "vbuf": torch.cat(vs).contiguous(),
            "table": (ctypes.c_int * len(table))(*table)}


def encoder_plain(x: torch.Tensor, packed: Dict) -> torch.Tensor:
    """Plain version of the encoder kernel: the block sequence on the
    blocks' plain versions. x (B, H, W, 3) bf16 -> (B, H/8, W/8, 128)."""
    return run_stages(x, packed, ENC_STAGES)


def decoder_plain(enc: torch.Tensor, packed: Dict) -> torch.Tensor:
    """Plain version of the decoder kernel: enc (B, H/8, W/8, 128) bf16 ->
    S (B, H, 2C) f32."""
    return run_stages(enc, packed, DEC_STAGES)


def _flat(packed: Dict, n: int):
    wp = check_cuda(packed["wbuf"], BF16, name="wbuf")
    vp = check_cuda(packed["vbuf"], F32, name="vbuf")
    if len(packed["table"]) != 3 * n:
        raise ValueError(f"offset table of {len(packed['table'])} entries, "
                         f"expected {3 * n}")
    return wp, vp, packed["table"], 3 * n


# the widest images the fused kernels take: their NB1D row tiles hold whole
# rows, NB1D-64 of W/4 and NB1D-128 of W/8 pixels (`ops/nb1d.py::
# max_width`), NB1D-16 of W/2 in the decoder
MAX_WIDTH = 512
SCRATCH_PLANES = 3  # the block input, the pass A output, the block output


def encoder_fused_kernel(x: torch.Tensor, packed: Dict) -> torch.Tensor:
    """The whole encoder in one cooperative launch: x (B, H, W, 3) bf16,
    H and W multiples of 8, W <= MAX_WIDTH -> enc (B, H/8, W/8, 128) bf16.
    Raises for anything else, and for a CPU tensor."""
    B, H, W, cin = x.shape
    if cin != 3 or H % 8 or W % 8 or W > MAX_WIDTH:
        raise ValueError(f"encoder_fused kernel: images {tuple(x.shape)}, "
                         "expected (B, H, W, 3) with H, W multiples of 8, "
                         f"W <= {MAX_WIDTH}")
    xp = check_cuda(x, BF16, name="images")
    wp, vp, table, n = _flat(packed, len(ENC_STAGES))
    scratch = torch.empty(SCRATCH_PLANES * 4 * B * H * W, dtype=BF16,
                          device=x.device)
    out = torch.empty(B, H // 8, W // 8, 128, dtype=BF16, device=x.device)
    barriers = torch.empty(1, dtype=torch.int32, device=x.device)
    launch(kernel("encoder_fused", "ld_encoder_fused", "ppppipppiiip"),
           x.device, xp, wp, vp, table, n, scratch.data_ptr(),
           out.data_ptr(), barriers.data_ptr(), B, H, W)
    encoder_fused_kernel.launches += 1
    encoder_fused_kernel.barriers = barriers
    return out


encoder_fused_kernel.launches = 0
encoder_fused_kernel.barriers = None


def decoder_fused_kernel(enc: torch.Tensor, packed: Dict) -> torch.Tensor:
    """The whole decoder, head, activation, row mask and WLS row sums in
    one cooperative launch: enc (B, h, w, 128) bf16 -> S (B, 8h, 2C) f32 =
    [S0 | S1]. Raises for anything else, and for a CPU tensor."""
    B, h, w, cin = enc.shape
    head = packed["head"]
    C = head["bias"].shape[0]
    if cin != 128 or head["xs"].shape[0] != 8 * w or 8 * w > MAX_WIDTH:
        raise ValueError(f"decoder_fused kernel: enc {tuple(enc.shape)}, "
                         f"expected (B, h, w, 128) with 8w = "
                         f"{head['xs'].shape[0]} columns, 8w <= {MAX_WIDTH}")
    ep = check_cuda(enc, BF16, name="enc")
    wp, vp, table, n = _flat(packed, len(DEC_STAGES))
    scratch = torch.empty(SCRATCH_PLANES * 256 * B * h * w, dtype=BF16,
                          device=enc.device)
    S = torch.empty(B, 8 * h, 2 * C, dtype=F32, device=enc.device)
    barriers = torch.empty(1, dtype=torch.int32, device=enc.device)
    launch(kernel("decoder_fused", "ld_decoder_fused", "ppppipppiiiiiip"),
           enc.device, ep, wp, vp, table, n, scratch.data_ptr(),
           S.data_ptr(), barriers.data_ptr(), B, h, w, C, head["zero_rows"],
           head["act"])
    decoder_fused_kernel.launches += 1
    decoder_fused_kernel.barriers = barriers
    return S


decoder_fused_kernel.launches = 0
decoder_fused_kernel.barriers = None

INFO_KEYS = ("registers", "local_bytes", "blocks_per_sm", "warps_per_sm",
             "grid", "smem_bytes", "threads", "sms")


def fused_info(which: str, packed: Dict, B: int, H: int, W: int,
               device) -> Dict[str, int]:
    """What the card gives one launch of the whole encoder ("encoder", on
    images (B, H, W, 3)) or the whole decoder ("decoder", on its enc (B,
    H/8, W/8, 128)): registers and local (spilled) bytes a thread, blocks
    and warps resident on one SM, grid blocks, dynamic shared memory a
    block, threads a block, SMs (`INFO_KEYS`). Builds the kernel; needs
    the card."""
    stages = ENC_STAGES if which == "encoder" else DEC_STAGES
    _, _, table, n = _flat(packed, len(stages))
    shape = (B, H, W) if which == "encoder" else (B, H // 8, W // 8)
    info = (ctypes.c_int * len(INFO_KEYS))()
    fn = kernel(f"{which}_fused", f"ld_{which}_fused_info", "ppiiii")
    with torch.cuda.device(device):
        rc = fn(info, table, n, *shape)
    if rc != 0:
        raise RuntimeError(f"ld_{which}_fused_info failed: CUDA error {rc}")
    return dict(zip(INFO_KEYS, info))
