"""Mutation check of the deferred-copy phase (`chip_smoke.py --defer-only`)
and of the bf16 3-tap tiles' checks (`chip_smoke.py --tiles-only`).

Each of MUTATIONS skips the first `cp.async` wait of one ring loop (the
iteration i = 0), so that loop reads its first chunk before the chunk has
landed: the fault that the "defer" build (-DLD_DEFER_CP_ASYNC,
`csrc/tc_common.cuh`) exists to make visible; each runs `--defer-only`.
Each of TILE_MUTATIONS plants a fault of the bf16 tiles' index plan that
only their checks against the plain versions can see (the prologue
applied to rows that the tap zeroed, a tap offset off by one); each runs
`--tiles-only`. For each mutation this tool copies the checkout into
OUT/<name> (build outputs left out), applies the mutation there, runs
chip_smoke.py in the copy with the mutation's flag, writes its output to
OUT/<name>.log and prints the exit code and the lines that failed. It
exits 1 if a check passes on any mutated copy. Needs a card, nvcc and a
checkout; the checkout itself is never modified. Names after OUT run
those mutations alone.

    python -m lanedetection_end2end_tpu_torch.tools.defer_mutations OUT \
        [NAME ...]
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = "lanedetection_end2end_tpu_torch/csrc/"
_F32 = "    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk i landed"
_F32_NEW = "    if (i > 0) cp_async_wait<STAGES - 2>();"
_F32_CONV = ("    cp_async_wait_n(nst - 2);  // this thread's copies of chunk i "
             "landed")
_F32_CONV_NEW = "    if (i > 0) cp_async_wait_n(nst - 2);"
_BF16 = ("    cp_async_wait<T::STAGES - 2>();  // this thread's copies of chunk "
         "i landed")
_BF16_NEW = "    if (i > 0) cp_async_wait<T::STAGES - 2>();"
# name -> (header, occurrence (1-based) of the old text, old, new)
MUTATIONS = {
    # the row tile's pass loop: wait and barrier both skipped at i = 0
    "nb1d_first_wait": (
        "nb1d.cuh", 1,
        "    ldtc::cp_async_wait<STAGES - 2>();  // this thread's chunk i "
        "landed\n    // every thread's chunk i (and the staged rows) "
        "visible; every warp\n    // done with chunk i - 1, whose stage is "
        "refilled next\n    __syncthreads();",
        "    if (i > 0) { ldtc::cp_async_wait<STAGES - 2>(); "
        "__syncthreads(); }"),
    # the float32 3-tap convolution tile (K6 / K7 forward and dx, K11)
    "conv3tap_f32_conv_first_wait": ("conv3tap_f32.cuh", 1, _F32_CONV,
                                     _F32_CONV_NEW),
    # the float32 weight-gradient tile at C = 64, 128
    "conv3tap_f32_wgrad_first_wait": ("conv3tap_f32.cuh", 1, _F32, _F32_NEW),
    # the stride-2 tile (K8 / K9, the fused kernels' stride-2 passes)
    "conv_s2_mma_first_wait": (
        "conv_s2_mma.cuh", 1,
        "    ldtc::cp_async_wait<MM_STAGES - 2>();  // this thread's chunk i "
        "landed",
        "    if (i > 0) ldtc::cp_async_wait<MM_STAGES - 2>();"),
    # the bf16 3-tap tiles (K6 / K7 forward and dx, K11): the convolution
    # and the weight gradient
    "conv3tap_conv_first_wait": (
        "conv3tap.cuh", 1,
        "    cp_async_wait_upto(nst - 2);  // this thread's copies of chunk i "
        "landed",
        "    if (i > 0) cp_async_wait_upto(nst - 2);"),
    "wgrad3tap_first_wait": ("wgrad3tap.cuh", 1, _BF16, _BF16_NEW),
}
TILE_MUTATIONS = {
    # the convolution applies the prologue to the staged rows that the
    # copy zero-filled (taps off the plane), making them relu(add)
    "conv3tap_prologue_on_padding": (
        "conv3tap.cuh", 1,
        "        if (geo.staged_pixel(R0, h0, c0, j) < 0) continue;\n", ""),
    # the weight gradient applies the prologue to its zero-filled pixels
    "wgrad3tap_prologue_on_padding": (
        "wgrad3tap.cuh", 1,
        "        if (staged_pixel(R0, h0, c0, j) < 0) continue;\n", ""),
    # the convolution's tap +d reads one staged row too far
    "conv3tap_tap_off_by_one": (
        "conv3tap.cuh", 1,
        "      const int base = geo.base(t);",
        "      const int base = geo.base(t) + (t == 2);"),
}
FLAGS = {**{n: "--defer-only" for n in MUTATIONS},
         **{n: "--tiles-only" for n in TILE_MUTATIONS}}
_LEFT_OUT = shutil.ignore_patterns("_build", "_smoke", "_archive", ".git",
                                   "__pycache__")


def mutate(text: str, nth: int, old: str, new: str) -> str:
    """`text` with the nth occurrence of `old` replaced by `new`."""
    parts = text.split(old)
    if len(parts) <= nth:
        raise ValueError(f"occurrence {nth} not found ({len(parts) - 1})")
    return old.join(parts[:nth]) + new + old.join(parts[nth:])


def main(argv) -> int:
    if not argv or any(n not in FLAGS for n in argv[1:]):
        print(__doc__, file=sys.stderr)
        return 2
    names = argv[1:] or list(FLAGS)
    out = Path(argv[0]).resolve()
    out.mkdir(parents=True, exist_ok=True)
    missed = []
    for name in names:
        header, nth, old, new = {**MUTATIONS, **TILE_MUTATIONS}[name]
        copy = out / name
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(ROOT, copy, ignore=_LEFT_OUT)
        src = copy / CSRC / header
        src.write_text(mutate(src.read_text(), nth, old, new))
        run = subprocess.run([sys.executable, "chip_smoke.py", FLAGS[name]],
                             cwd=copy, capture_output=True, text=True)
        log = run.stdout + run.stderr
        (out / f"{name}.log").write_text(log)
        print(f"mutation {name} ({header}, occurrence {nth}): "
              f"{FLAGS[name]} exit {run.returncode}")
        for line in log.splitlines():
            if line.endswith("FAIL"):
                print("  " + line)
        if run.returncode == 0:
            missed.append(name)
    if missed:
        print(f"the checks missed: {', '.join(missed)}")
        return 1
    print(f"the checks failed on all {len(names)} mutations")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
